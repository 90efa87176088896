"""RMVPE pitch extractor (``conan_tpu/models/rmvpe.py``).

E2E0 (DeepUnet0 + conv head + BiGRU + linear + sigmoid) over a 128-bin htk
log-mel, the local-average or Viterbi cents decode, glitch removal and the
resampling of the 10 ms curve to the target hop, as the original system's
``utils/extract_f0_rmvpe.py`` runs it to precompute ``*_f0.npy`` files.

The network is stock PyTorch in NCHW (H = time, W = mel): eval-form batch
norm with the stored statistics, 3x3 convs, the decoder's up-conv as
``conv_transpose2d``, and one cuDNN GRU call per direction pair over the
whole sequence. It runs in fp32 with TF32 off for matmuls, convs and the GRU
(the ``exact`` rung). ``params_from_torch`` reads the published checkpoint's
state dict (``ckpt["model"]``) through ``torch_names``; its vestigial
TimbreFilter keys (created, unused in the reference forward) are ignored.
The decoders are numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from conan_tpu_torch.checkpoint import params_from_state_dict, state_dict_from_params
from conan_tpu_torch.device import resolve_device
from conan_tpu_torch.nn import inits
from conan_tpu_torch.nn.module import Params
from conan_tpu_torch.ops.precision import precision_scope
from conan_tpu_torch.ops.stft import mel_filterbank_np, stft_magnitude

SAMPLE_RATE = 16000
N_CLASS = 360
N_MELS = 128
MEL_FMIN = 30
MEL_FMAX = 8000
WINDOW_LENGTH = 1024
CONST = 1997.3794084376191
GRU_HIDDEN = 256
BN_EPS = 1e-5


def mel_spectrogram(audio: torch.Tensor, hop_length: int = 160, clamp: float = 1e-5
                    ) -> torch.Tensor:
    """[B, T] → [B, 128, frames] log-mel (spec.py MelSpectrogram, htk bank):
    the STFT of the wav padded by (512, 512) zeros, uncentred."""
    basis = torch.from_numpy(mel_filterbank_np(SAMPLE_RATE, WINDOW_LENGTH, N_MELS, MEL_FMIN,
                                               MEL_FMAX, htk=True)).to(audio.device)
    audio = F.pad(audio, (WINDOW_LENGTH // 2, (WINDOW_LENGTH + 1) // 2))
    mag = stft_magnitude(audio, n_fft=WINDOW_LENGTH, hop=hop_length, center=False)
    return torch.log(torch.clamp(basis @ mag.transpose(1, 2), min=clamp))


@dataclasses.dataclass(frozen=True)
class RMVPEConfig:
    n_blocks: int = 4
    n_gru: int = 1
    kernel_size: tuple[int, int] = (2, 2)
    en_de_layers: int = 5
    inter_layers: int = 4
    in_channels: int = 1
    en_out_channels: int = 16


def _bn(x: torch.Tensor, p: Params) -> torch.Tensor:
    return F.batch_norm(x, p["mean"], p["var"], p["scale"], p["bias"], training=False,
                        eps=BN_EPS)


def _conv_block_res(x: torch.Tensor, p: Params) -> torch.Tensor:
    h = F.relu(_bn(F.conv2d(x, p["c1"]["w"], padding=1), p["bn1"]))
    h = F.relu(_bn(F.conv2d(h, p["c2"]["w"], padding=1), p["bn2"]))
    if "shortcut" in p:
        return h + F.conv2d(x, p["shortcut"]["w"], p["shortcut"]["b"])
    return h + x


# the GRU's leaves in torch's flat-weight order, with their state-dict names
GRU_NAMES = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0", "b_ih": "bias_ih_l0",
             "b_hh": "bias_hh_l0", "w_ih_r": "weight_ih_l0_reverse",
             "w_hh_r": "weight_hh_l0_reverse", "b_ih_r": "bias_ih_l0_reverse",
             "b_hh_r": "bias_hh_l0_reverse"}


def _bigru(x: torch.Tensor, p: Params) -> torch.Tensor:
    """[B, T, F] → [B, T, 2·256]: torch's bidirectional one-layer GRU (gates
    r, z, n), one call over the whole sequence (cuDNN on the card)."""
    h0 = x.new_zeros(2, x.shape[0], GRU_HIDDEN)
    out, _ = torch.gru(x, h0, [p[k] for k in GRU_NAMES], True, 1, 0.0, False, True, True)
    return out


def flat_gru_weights(p: Params) -> Params:
    """The GRU's leaves copied into one buffer in cuDNN's layout, as
    ``nn.GRU.flatten_parameters`` lays them out, each leaf a view of it:
    cuDNN then reads them in place instead of compacting them at every call.
    The module is built on the meta device, so no random init is drawn."""
    gru = torch.nn.GRU(p["w_ih"].shape[1], GRU_HIDDEN, batch_first=True, bidirectional=True,
                       device="meta").to_empty(device=p["w_ih"].device)
    with torch.no_grad():
        for k, name in GRU_NAMES.items():
            getattr(gru, name).copy_(p[k])
    gru.flatten_parameters()
    return {k: getattr(gru, name).detach() for k, name in GRU_NAMES.items()}


class E2E0:
    """DeepUnet0 + conv head + BiGRU + linear + sigmoid (model.py:8-32)."""

    def __init__(self, cfg: RMVPEConfig = RMVPEConfig()):
        self.cfg = cfg

    def _levels(self) -> list[tuple[str, int, int, int]]:
        """(kind, index, in, out channels) of each ConvBlockRes level: the
        encoder's (1 → 16 … 128 → 256), the intermediate's (256 → 512,
        then 512 → 512), then each decoder level's blocks after the concat
        (512 → 256 … 32 → 16), whose up-conv maps the same in → out."""
        cfg = self.cfg
        c = cfg.en_out_channels
        top = c << (cfg.en_de_layers - 1)
        return ([("enc", i, cfg.in_channels if i == 0 else c << (i - 1), c << i)
                 for i in range(cfg.en_de_layers)]
                + [("inter", i, top if i == 0 else 2 * top, 2 * top)
                   for i in range(cfg.inter_layers)]
                + [("dec", i, (2 * top) >> i, top >> i) for i in range(cfg.en_de_layers)])

    # ----------------------------------------------------------- params
    def torch_names(self) -> Params:
        """The reference E2E0's state-dict key of each leaf (``checkpoint.py``);
        a level's first block has a 1x1 shortcut where its channels change."""
        def bn(pre):
            return {"scale": f"{pre}.weight", "bias": f"{pre}.bias",
                    "mean": f"{pre}.running_mean", "var": f"{pre}.running_var"}

        def cbr(pre, shortcut):
            p = {"c1": {"w": f"{pre}.conv.0.weight"}, "bn1": bn(f"{pre}.conv.1"),
                 "c2": {"w": f"{pre}.conv.3.weight"}, "bn2": bn(f"{pre}.conv.4")}
            if shortcut:
                p["shortcut"] = {"w": f"{pre}.shortcut.weight", "b": f"{pre}.shortcut.bias"}
            return p

        blocks = {"enc": "unet.encoder.layers.{}.conv",
                  "inter": "unet.intermediate.layers.{}.conv",
                  "dec": "unet.decoder.layers.{}.conv2"}
        out: Params = {"enc_bn": bn("unet.encoder.bn")}
        for kind, i, cin, cout in self._levels():
            pre = blocks[kind].format(i)
            lp = out[f"{kind}{i}"] = {f"b{j}": cbr(f"{pre}.{j}", j == 0 and cin != cout)
                                      for j in range(self.cfg.n_blocks)}
            if kind == "dec":
                lp["up"] = {"w": f"unet.decoder.layers.{i}.conv1.0.weight"}
                lp["up_bn"] = bn(f"unet.decoder.layers.{i}.conv1.1")
        out["cnn"] = {"w": "cnn.weight", "b": "cnn.bias"}
        out["gru"] = {k: f"fc.0.gru.{name}" for k, name in GRU_NAMES.items()}
        out["fc"] = {"w": "fc.1.weight", "b": "fc.1.bias"}
        return out

    def init(self, gen: torch.Generator) -> Params:
        """Random parameters in the reference's shapes, from torch's default
        inits (BN statistics 0 and 1), for runs without the published weights."""
        def conv(o, i, k, bias=True):
            shape = (o, i, k, k)
            p = {"w": inits.kaiming_uniform(gen, shape)}
            if bias:
                p["b"] = inits.default_bias(gen, (o,), shape)
            return p

        def bn(c):
            return {"scale": torch.ones(c), "bias": torch.zeros(c), "mean": torch.zeros(c),
                    "var": torch.ones(c)}

        def cbr(cin, cout, shortcut):
            p = {"c1": conv(cout, cin, 3, bias=False), "bn1": bn(cout),
                 "c2": conv(cout, cout, 3, bias=False), "bn2": bn(cout)}
            if shortcut:
                p["shortcut"] = conv(cout, cin, 1)
            return p

        out: Params = {"enc_bn": bn(self.cfg.in_channels)}
        for kind, i, cin, cout in self._levels():
            lp = out[f"{kind}{i}"] = {
                f"b{j}": cbr(cin if j == 0 else cout, cout, j == 0 and cin != cout)
                for j in range(self.cfg.n_blocks)}
            if kind == "dec":
                # ConvTranspose2d's weight is [in, out, 3, 3]; torch takes
                # its fan-in from dim 1, as kaiming_uniform does here
                lp["up"] = {"w": inits.kaiming_uniform(gen, (cin, cout, 3, 3))}
                lp["up_bn"] = bn(cout)
        out["cnn"] = conv(3, self.cfg.en_out_channels, 3)
        bound = 1 / math.sqrt(GRU_HIDDEN)
        n_in, H = 3 * N_MELS, GRU_HIDDEN
        shapes = {"w_ih": (3 * H, n_in), "w_hh": (3 * H, H), "b_ih": (3 * H,), "b_hh": (3 * H,)}
        out["gru"] = {k: inits.uniform(gen, shapes[k[:4]], -bound, bound) for k in GRU_NAMES}
        w = inits.kaiming_uniform(gen, (N_CLASS, 2 * H))
        out["fc"] = {"w": w, "b": inits.default_bias(gen, (N_CLASS,), w.shape)}
        return out

    def params_from_torch(self, sd, device=None) -> Params:
        """A reference state dict (tensors or numpy arrays) → params on
        ``device`` (None: the card)."""
        return params_from_state_dict(sd, self.torch_names(), device)

    def params_to_torch(self, params: Params) -> dict[str, torch.Tensor]:
        return state_dict_from_params(params, self.torch_names())

    # ----------------------------------------------------------- forward
    def apply(self, params: Params, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, 128, T] (T a multiple of 32) → salience [B, T, 360]."""
        cfg = self.cfg
        x = _bn(mel.transpose(1, 2)[:, None], params["enc_bn"])      # [B, 1, T, 128]
        skips = []
        for i in range(cfg.en_de_layers):
            for j in range(cfg.n_blocks):
                x = _conv_block_res(x, params[f"enc{i}"][f"b{j}"])
            skips.append(x)
            x = F.avg_pool2d(x, cfg.kernel_size)
        for i in range(cfg.inter_layers):
            for j in range(cfg.n_blocks):
                x = _conv_block_res(x, params[f"inter{i}"][f"b{j}"])
        for i in range(cfg.en_de_layers):
            lp = params[f"dec{i}"]
            x = F.conv_transpose2d(x, lp["up"]["w"], stride=2, padding=1, output_padding=1)
            x = torch.cat([F.relu(_bn(x, lp["up_bn"])), skips[-1 - i]], dim=1)
            for j in range(cfg.n_blocks):
                x = _conv_block_res(x, lp[f"b{j}"])
        x = F.conv2d(x, params["cnn"]["w"], params["cnn"]["b"], padding=1)   # [B, 3, T, 128]
        x = x.transpose(1, 2).flatten(-2)           # [B, T, 3·128], the channel major
        x = _bigru(x, params["gru"])
        return torch.sigmoid(F.linear(x, params["fc"]["w"], params["fc"]["b"]))


# ---------------------------------------------------------------------------
# decode + postprocess (utils.py / inference.py), numpy
# ---------------------------------------------------------------------------

def to_local_average_f0(hidden: np.ndarray, center: np.ndarray | None = None,
                        thred: float = 0.03) -> np.ndarray:
    """[B, T, 360] salience → [B, T] f0 Hz (utils.py:8-24). ``center``
    [B, T, 1] overrides the argmax bins (the Viterbi decoder's path)."""
    idx = np.arange(N_CLASS)[None, None, :]
    idx_cents = idx * 20 + CONST
    if center is None:
        center = np.argmax(hidden, axis=2, keepdims=True)
    start = np.clip(center - 4, 0, None)
    end = np.clip(center + 5, None, N_CLASS)
    mask = (idx >= start) & (idx < end)
    weights = hidden * mask
    product_sum = np.sum(weights * idx_cents, axis=2)
    weight_sum = np.sum(weights, axis=2)
    cents = product_sum / (weight_sum + (weight_sum == 0))
    f0 = 10 * 2 ** (cents / 1200)
    uv = hidden.max(axis=2) < thred
    return f0 * ~uv


def _viterbi(prob: np.ndarray, transition: np.ndarray) -> np.ndarray:
    """librosa.sequence.viterbi: prob [S, T] observation likelihoods,
    transition [S, S] row-stochastic, a uniform initial distribution → the
    most likely state path [T]."""
    S, T = prob.shape
    tiny = np.finfo(np.float64).tiny
    log_p = np.log(prob.astype(np.float64) + tiny)
    log_t = np.log(transition.astype(np.float64) + tiny)
    value = np.empty((T, S))
    ptr = np.empty((T, S), np.int64)
    value[0] = log_p[:, 0] + np.log(1.0 / S)
    for t in range(1, T):
        trans = value[t - 1][:, None] + log_t  # [S_prev, S]
        ptr[t] = np.argmax(trans, axis=0)
        value[t] = log_p[:, t] + trans[ptr[t], np.arange(S)]
    path = np.empty(T, np.int64)
    path[-1] = int(np.argmax(value[-1]))
    for t in range(T - 2, -1, -1):
        path[t] = ptr[t + 1][path[t + 1]]
    return path


def to_viterbi_f0(hidden: np.ndarray, thred: float = 0.03) -> np.ndarray:
    """[B, T, 360] salience → [B, T] f0 Hz: the Viterbi path of the bins
    under a banded triangular transition of half-width 30 (utils.py:27-44),
    then the local-average cents around it."""
    xx, yy = np.meshgrid(range(N_CLASS), range(N_CLASS))
    transition = np.maximum(30 - np.abs(xx - yy), 0).astype(np.float64)
    transition = transition / transition.sum(axis=1, keepdims=True)
    centers = []
    for b in range(hidden.shape[0]):
        prob = hidden[b].T  # [S, T]
        prob = prob / np.maximum(prob.sum(axis=0), 1e-20)
        centers.append(_viterbi(prob, transition))
    center = np.stack(centers)[:, :, None]
    return to_local_average_f0(hidden, center=center, thred=thred)


def postprocess_f0(f0: np.ndarray, fmin: float = 50, fmax: float = 1000,
                   min_gap: int = 2) -> np.ndarray:
    """Range clip and glitch removal (inference.py:46-59)."""
    f0 = f0.copy()
    f0[f0 < fmin] = 0
    f0[f0 > fmax] = 0
    for idx in range(f0.shape[0] - min_gap - 1):
        if (f0[idx] == 0 and f0[idx + min_gap + 1] == 0
                and np.sum(f0[idx: idx + min_gap + 2]) > 0):
            f0[idx: idx + min_gap + 2] = 0
    return f0


def resample_align_curve(points: np.ndarray, original_timestep: float,
                         target_timestep: float, align_length: int) -> np.ndarray:
    """(utils/audio/pitch_utils.py:92-104)."""
    t_max = (len(points) - 1) * original_timestep
    curve = np.interp(np.arange(0, t_max, target_timestep),
                      original_timestep * np.arange(len(points)),
                      points).astype(points.dtype)
    d = align_length - len(curve)
    if d < 0:
        curve = curve[:align_length]
    elif d > 0:
        curve = np.concatenate([curve, np.full(d, curve[-1])])
    return curve


class RMVPE:
    """The extractor (inference.py:16-156) on ``device`` (None: the card);
    inputs are 16 kHz, as the data preparation makes them."""

    def __init__(self, params: Params, hop_length: int = 160,
                 cfg: RMVPEConfig = RMVPEConfig(), device=None):
        self.device = resolve_device(device)
        self.model = E2E0(cfg)
        self.params = dict(params, gru=flat_gru_weights(params["gru"]))
        self.hop_length = hop_length

    @classmethod
    def from_torch_checkpoint(cls, path: str, hop_length: int = 160, device=None) -> "RMVPE":
        """The published ``rmvpe.pt``: its state dict under ``"model"``."""
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return cls(E2E0().params_from_torch(ckpt["model"], device), hop_length, device=device)

    def salience(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, T] wav on the device → [B, frames, 360]. The log-mel is padded
        with zeros to a multiple of 32 frames before the network (the
        backward GRU reads those frames) and the output cut back."""
        with torch.inference_mode(), precision_scope("exact", self.device):
            mel = mel_spectrogram(audio, self.hop_length)
            n = mel.shape[-1]
            mel = F.pad(mel, (0, 32 * ((n - 1) // 32 + 1) - n))
            return self.model.apply(self.params, mel)[:, :n]

    def infer_from_audio(self, audio: np.ndarray, thred: float = 0.03,
                         use_viterbi: bool = False) -> np.ndarray:
        if audio.ndim == 1:
            audio = audio[None]
        wav = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device)
        hidden = self.salience(wav).cpu().numpy()
        decode = to_viterbi_f0 if use_viterbi else to_local_average_f0
        return decode(hidden, thred=thred)[0]

    def get_pitch(self, waveform: np.ndarray, sample_rate: int, hop_size: int, length: int,
                  fmin: float = 50, fmax: float = 1000, use_viterbi: bool = False):
        """→ (f0 [length] Hz at ``hop_size``, 0 where unvoiced; uv [length] bool)."""
        if sample_rate != SAMPLE_RATE:
            raise ValueError(f"sample rate {sample_rate} != {SAMPLE_RATE} (resample offline)")
        f0 = postprocess_f0(self.infer_from_audio(waveform, use_viterbi=use_viterbi),
                            fmin, fmax)
        uv = f0 == 0
        ts = hop_size / sample_rate
        f0_res = resample_align_curve(f0, 0.01, ts, length)
        uv_res = resample_align_curve(uv.astype(np.float32), 0.01, ts, length) > 0.5
        f0_res[uv_res] = 0
        return f0_res, uv_res
