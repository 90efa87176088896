"""Log-mel: kernel K1 in its two forms, each with its plain version.

``logmel`` is the counterpart of ``conan_tpu/ops/pallas_stft.py:pallas_logmel``
in its serving form (``pallas_wav2mel_librosa``: constant centre pad, eps 0,
clip 1e-6, log10). ``logmel_gan`` is its GAN-loss form
(``pallas_wav2mel_gan_diff``: clip to [-1, 1], reflect pad of (n_fft-hop)/2,
no centre pad, eps 1e-9 under the sqrt, clip 1e-5, ln), differentiable: the
forward is K1 and the backward the analytic chain of ``_logmel_bwd``
(log → mel → magnitude → DFT → overlap-add) in plain torch ops, as the JAX
package's backward is XLA and not Pallas. On a CUDA tensor each launches the
hand-written kernel in ``csrc/logmel.cu`` (one launch: framing, window, a
shared-memory FFT, magnitude, banded mel sum and log); on a CPU tensor each
runs its plain version (the GAN form's under the same analytic backward).
There is no other route: any other device raises. Both forms, and the GAN
form's backward, stay fp32 under every training rung (``ops/precision.py``):
the TPU kernel's body (``pallas_stft.py:34-45``) does not read the precision
scope, and K1-GAN is a small part of a vocoder step.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from conan_tpu_torch.ops.precision import precision_scope
from conan_tpu_torch.ops.stft import (_dft_kernel_np, _window_np, frame_count,
                                      mel_filterbank_np, overlap_add, stft_magnitude)

CLIP = 1e-6  # log10(max(mel, 1e-6)), librosa_wav2spec's floor
GAN_EPS, GAN_CLIP = 1e-9, 1e-5  # sqrt(re² + im² + 1e-9), ln(max(mel, 1e-5)): cal_mel_spec


def _constants_np(cfg):
    """(basis [n_fft, 2·bins], mel weights [bins, mels]) from the shared numpy
    builders, so kernel, plain path and the JAX package use the same numbers."""
    basis = _dft_kernel_np(cfg.n_fft, cfg.win_length)
    melw = mel_filterbank_np(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                             float(cfg.fmin), float(cfg.fmax)).T
    return basis, melw


def _twiddles_np(n_fft: int) -> np.ndarray:
    """[n_fft/2, 2] fp32 (re, im) of exp(-2πi k / n_fft), computed in float64:
    the FFT's twiddle factors."""
    w = np.exp(-2j * np.pi * np.arange(n_fft // 2) / n_fft)
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


def _mel_bands_np(melw: np.ndarray):
    """The kernel's banded form of the filterbank ``melw`` [bins, mels]: per
    mel the first bin and count of its contiguous run of weights (first to
    last nonzero; count 0 for a mel with none) and the run's offset into one
    compact fp32 array of all runs. Returns (first, count, offset, weights)."""
    first, count, offset, runs = [], [], [], []
    n = 0
    for col in melw.T:
        nz = np.flatnonzero(col)
        lo, c = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        first.append(lo)
        count.append(c)
        offset.append(n)
        runs.append(col[lo:lo + c])
        n += c
    ints = [np.asarray(a, dtype=np.int32) for a in (first, count, offset)]
    return (*ints, np.concatenate(runs).astype(np.float32))


def logmel_reference(wav: torch.Tensor, cfg) -> torch.Tensor:
    """Plain version: [B, T] → [B, T//hop + 1, n_mels] log10-mel. ``unfold``
    framing after the constant centre pad, matmul with the DFT basis, sqrt
    (``stft_magnitude``), matmul with the filterbank, log10."""
    mag = stft_magnitude(wav, n_fft=cfg.n_fft, hop=cfg.hop, win_length=cfg.win_length,
                         center=True, pad_mode="constant")
    melw = torch.from_numpy(_constants_np(cfg)[1].copy()).to(wav.device, wav.dtype)
    return torch.log10(torch.clamp(mag @ melw, min=CLIP))


def gan_pad(wav: torch.Tensor, cfg) -> torch.Tensor:
    """The GAN form's input: clipped to [-1, 1], reflect-padded by
    (n_fft - hop)/2 on both sides, so that [B, T] gives T // hop frames."""
    p = (cfg.n_fft - cfg.hop) // 2
    return F.pad(torch.clamp(wav, -1.0, 1.0)[:, None], (p, p), mode="reflect")[:, 0]


def _centred_dft(padded: torch.Tensor, cfg, basis: torch.Tensor):
    """(re, im, mag) of the padded wav's frames, the GAN form's DFT and
    magnitude. Each frame is centred before the DFT and its mean's transform
    added back, frames @ basis = (frames - m) @ basis + m · Σ_t basis[t] (the
    column sums in float64): the same function, with fp32's rounding set by
    the frame's variation rather than its offset. A generator's wav carries a
    DC offset, under which the uncentred fp32 product lost the quiet low bins
    to 1e-4 in the log, and a spectrogram discriminator's gradients amplify
    that thousandfold. The plain forward and the backward both call it, so
    the backward's ``g / mel`` and ``dmag / mag`` see the forward's numbers."""
    frames = padded.unfold(-1, cfg.n_fft, cfg.hop)                # [B, F, n_fft]
    mean = frames.mean(-1, keepdim=True)
    ri = (frames - mean) @ basis + mean * basis.double().sum(0).to(padded.dtype)
    n_bins = cfg.n_fft // 2 + 1
    re, im = ri[..., :n_bins], ri[..., n_bins:]
    return re, im, torch.sqrt(re * re + im * im + GAN_EPS)


def _gan_padded_reference(padded: torch.Tensor, cfg) -> torch.Tensor:
    """ln-mel of the padded wav (``_centred_dft``, filterbank, clip, ln)."""
    basis, melw = (torch.from_numpy(c.copy()).to(padded.device, padded.dtype)
                   for c in _constants_np(cfg))
    _, _, mag = _centred_dft(padded, cfg, basis)
    return torch.log(torch.clamp(mag @ melw, min=GAN_CLIP))


def logmel_gan_reference(wav: torch.Tensor, cfg) -> torch.Tensor:
    """Plain version of the GAN form: [B, T] → [B, T // hop, n_mels] ln-mel,
    differentiable by torch's autograd."""
    return _gan_padded_reference(gan_pad(wav, cfg), cfg)


def _gan_vjp(padded: torch.Tensor, g: torch.Tensor, cfg, basis: torch.Tensor,
             melw: torch.Tensor) -> torch.Tensor:
    """d(sum(g · ln-mel))/d(padded), the chain of pallas_stft.py:_logmel_bwd:
    the forward's DFT, magnitude and mel are recomputed as the plain forward
    computes them (``_centred_dft``), then log → mel → magnitude → DFT →
    overlap-add."""
    re, im, mag = _centred_dft(padded, cfg, basis)
    mel = mag @ melw
    dmel = torch.where(mel > GAN_CLIP, g / torch.clamp(mel, min=GAN_CLIP), 0.0)
    scale = (dmel @ melw.T) / mag
    dframes = torch.cat([scale * re, scale * im], dim=-1) @ basis.T
    return overlap_add(dframes, cfg.hop, padded.shape[1])


def _check_n_fft(n_fft: int) -> None:
    if n_fft < 2 or n_fft > 8192 or n_fft & (n_fft - 1):
        raise ValueError(f"logmel: n_fft {n_fft} is not a power of two from 2 to 8192")


class LogmelKernel:
    """Wrapper of the CUDA kernel in its serving form: checks its inputs,
    allocates the output, launches on the current stream and counts its
    launches in ``launches``. The kernel's tables (window, twiddles, mel
    bands) are uploaded once per (device, config) by ``tables``; the dense
    DFT basis and filterbank, which the GAN form's backward and the
    yardsticks use, by ``dense_constants``."""

    def __init__(self):
        self.launches = 0
        self._dense: dict = {}
        self._tables: dict = {}

    @staticmethod
    def _key(cfg, device: torch.device):
        return (device, cfg.n_fft, cfg.win_length, cfg.sample_rate, cfg.n_mels,
                float(cfg.fmin), float(cfg.fmax))

    def dense_constants(self, cfg, device: torch.device):
        """(DFT basis [n_fft, 2·bins], filterbank [bins, mels]) on ``device``."""
        key = self._key(cfg, device)
        if key not in self._dense:
            basis, melw = _constants_np(cfg)
            self._dense[key] = (torch.from_numpy(basis).to(device),
                                torch.from_numpy(melw.copy()).to(device))
        return self._dense[key]

    def tables(self, cfg, device: torch.device):
        """The kernel's constants on ``device``: (window [n_fft] fp32,
        twiddles [n_fft/2, 2] fp32, band first, count, offset [mels] int32,
        band weights fp32). Raises ValueError for an n_fft the FFT does not
        take."""
        _check_n_fft(cfg.n_fft)
        key = self._key(cfg, device)
        if key not in self._tables:
            window = _window_np(cfg.n_fft, cfg.win_length).astype(np.float32)
            consts = (window, _twiddles_np(cfg.n_fft), *_mel_bands_np(_constants_np(cfg)[1]))
            self._tables[key] = tuple(torch.from_numpy(c).to(device) for c in consts)
        return self._tables[key]

    def launch(self, wav: torch.Tensor, cfg, *, pad: int, n_frames: int, eps: float,
               clip: float, out_scale: float) -> torch.Tensor:
        """K1 on a CUDA wav [B, T]: frame f reads wav[f·hop - pad + n] (zero
        outside), out = log(max(mel, clip)) · out_scale, [B, n_frames, n_mels]."""
        if wav.device.type != "cuda":
            raise ValueError(f"logmel: no kernel for device {wav.device}")
        if wav.dtype != torch.float32:
            raise TypeError(f"logmel: wav must be float32, got {wav.dtype}")
        if wav.dim() != 2 or not wav.is_contiguous() or wav.shape[0] == 0:
            raise ValueError(f"logmel: wav must be a contiguous non-empty [B, T], "
                             f"got {tuple(wav.shape)}")
        if n_frames < 1:
            raise ValueError(f"logmel: {wav.shape[1]} samples make no frame of {cfg.n_fft}")
        tables = self.tables(cfg, wav.device)
        from conan_tpu_torch.ops import native

        lib = native.load()
        B, T = wav.shape
        out = torch.empty(B, n_frames, cfg.n_mels, device=wav.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(wav.device).cuda_stream
        with torch.cuda.device(wav.device):
            err = lib.logmel_forward(
                wav.data_ptr(), *(c.data_ptr() for c in tables), out.data_ptr(), B, T,
                n_frames, cfg.n_fft, cfg.hop, pad, cfg.n_mels, eps, clip, out_scale, stream)
        if err != 0:
            raise RuntimeError(f"logmel kernel launch failed: cudaError {err}")
        self.launches += 1
        return out

    def __call__(self, wav: torch.Tensor, cfg) -> torch.Tensor:
        """Serving form: [B, T] → [B, T//hop + 1, n_mels] log10-mel."""
        if wav.device.type == "cpu":
            return logmel_reference(wav, cfg)
        return self.launch(wav, cfg, pad=cfg.n_fft // 2,
                           n_frames=frame_count(wav.shape[-1], cfg.n_fft, cfg.hop, center=True),
                           eps=0.0, clip=CLIP, out_scale=1.0 / math.log(10.0))


class _LogmelGanFunction(torch.autograd.Function):
    """Forward: K1 on a CUDA tensor, the plain forward on a CPU one.
    Backward: ``_gan_vjp``, the same on both."""

    @staticmethod
    def forward(ctx, padded, cfg, kernel):
        ctx.save_for_backward(padded)
        ctx.cfg, ctx.kernel = cfg, kernel
        if padded.device.type == "cpu":
            return _gan_padded_reference(padded, cfg)
        return kernel.launch(padded, cfg, pad=0,
                             n_frames=frame_count(padded.shape[1], cfg.n_fft, cfg.hop,
                                                  center=False),
                             eps=GAN_EPS, clip=GAN_CLIP, out_scale=1.0)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (padded,) = ctx.saved_tensors
        basis, melw = (c.to(padded.dtype)
                       for c in ctx.kernel.dense_constants(ctx.cfg, padded.device))
        with precision_scope("exact", padded.device):      # fp32 under every training rung
            return _gan_vjp(padded, g, ctx.cfg, basis, melw), None, None


class LogmelGanKernel(LogmelKernel):
    """K1 in its GAN-loss form, differentiable; ``launches`` counts its own
    forward launches apart from the serving form's."""

    def __call__(self, wav: torch.Tensor, cfg) -> torch.Tensor:
        """[B, T] → [B, T // hop, n_mels] ln-mel."""
        return _LogmelGanFunction.apply(gan_pad(wav, cfg), cfg, self)


logmel = LogmelKernel()
logmel_gan = LogmelGanKernel()
