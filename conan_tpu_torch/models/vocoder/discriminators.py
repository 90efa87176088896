"""The HiFi-GAN discriminators, MPD and MSD
(``conan_tpu/models/vocoder/discriminators.py:71-232``), and the multi-window
mel discriminator of the Conan acoustic GAN (``:258-358``).

Parameter trees and key paths are the JAX package's. Inputs are channels-last
wavs [B, T, 1]. Every discriminator has ``forward(params, x, mel=None)`` →
(logits [B, N], feature maps) for one batch of wavs, and the
multi-discriminators an ``apply(params, y, y_hat, mel=None)`` that runs it on
the real and the generated wavs as the JAX package's ``apply`` does; a caller
that needs only one side (the generator's adversarial loss without feature
matching) calls ``forward``. The MPD's feature maps are channels-first
[B, C, T/p, p] (the conv2d layout); the MSD's are channels-last [B, T, C].

With ``use_cond`` (hifigan_causal.py:349-355,426-428) a transposed conv
(80 → 1, kernel 2t, stride t, padding t/2, no weight norm) upsamples the
conditioning mel [B, T_mel, 80] to the rate of the discriminator's wav and
joins it as the first of two input channels: t is the hop for the MPD and
the MSD's full-rate scale, hop/2 and hop/4 for its pooled scales. As in the
JAX package it is computed as one matmul against the [80, 2t] kernel and a
one-frame overlap-add (kernel = 2 · stride, so each sample gets two terms).

The MPD's 2-D convs are ``F.conv2d`` at the training rung (``ops.conv.conv2d``;
the JAX package computes them with ``lax.conv``, outside any Pallas kernel). The MSD's grouped convs go
through ``ops.conv1d``, which runs kernel K2 on the card, conditional or not
(the conditioning changes only the first, dense layer).

The mel discriminator (``SingleWindowDisc``, ``MultiWindowDiscriminator``)
is ``F.conv2d`` (``ops.conv.conv2d``) in NCHW, where the JAX package is channels-last: its
hidden maps are [B, C, T', M'], and the head's flatten in channels-first
order is then a plain reshape. Its random parts (each window's crop start,
``Dropout2d`` over whole channels) are drawn from a ``torch.Generator`` on
the device; with none, no dropout and every crop starts at frame 0, unless
``start_frames`` names the starts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from conan_tpu_torch.nn import inits
from conan_tpu_torch.nn.blocks import init_linear, linear
from conan_tpu_torch.nn.module import Params
from conan_tpu_torch.ops.conv import conv1d, conv2d, spectral_norm_weight, weight_norm_weight
from conan_tpu_torch.ops.precision import dot_at_rung
from conan_tpu_torch.parallel import dist

LRELU = 0.1


def _wn_conv_init(gen: torch.Generator, out_ch: int, in_ch: int, *k: int) -> Params:
    """torch's default conv init, then weight norm attached: {v, g, b}."""
    shape = (out_ch, in_ch, *k)
    v = inits.kaiming_uniform(gen, shape)
    g = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))
    return {"v": v, "g": g, "b": inits.default_bias(gen, (out_ch,), shape)}


def _cond_net_init(gen: torch.Generator, t: int) -> Params:
    """ConvTranspose1d(80, 1, 2t, stride=t, padding=t//2), torch's default
    init: weight [in=80, out=1, 2t], no weight norm."""
    shape = (80, 1, 2 * t)
    return {"w": inits.kaiming_uniform(gen, shape), "b": inits.default_bias(gen, (1,), shape)}


def _cond_net_apply(p: Params, mel: torch.Tensor, t: int) -> torch.Tensor:
    """mel [B, T, 80] → [B, T·t, 1]: y[n] = mel[q]·W[r] + mel[q-1]·W[t+r] + b
    with q·t + r = n + t//2, r in [0, t)."""
    B, T, _ = mel.shape
    ab = dot_at_rung(mel, p["w"][:, 0, :])          # [B, T, 2t]
    y = F.pad(ab[..., :t], (0, 0, 0, 1)) + F.pad(ab[..., t:], (0, 0, 1, 0))
    y = y.reshape(B, (T + 1) * t)[:, t // 2:t // 2 + T * t]
    return y[..., None] + p["b"]


class DiscriminatorP:
    """Period discriminator: the wav as [T/p, p] through 2-D convs with
    (k, 1) kernels (hifigan_causal.py:347-389); with ``use_cond`` the mel
    upsampled by the hop joins as a second channel."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 use_cond: bool = False, hop: int = 320):
        self.period = period
        self.k = kernel_size
        self.s = stride
        self.use_cond = use_cond
        self.hop = hop
        self.layers = [(2 if use_cond else 1, 32), (32, 128), (128, 512), (512, 1024),
                       (1024, 1024)]

    def init(self, gen: torch.Generator) -> Params:
        p = {"convs": [_wn_conv_init(gen, co, ci, self.k, 1) for ci, co in self.layers],
             "post": _wn_conv_init(gen, 1, 1024, 3, 1)}
        if self.use_cond:
            p["cond"] = _cond_net_init(gen, self.hop)
        return p

    def forward(self, params: Params, x: torch.Tensor, mel: torch.Tensor | None = None):
        """x: [B, T, 1] (and the mel [B, T / hop, 80] with ``use_cond``) →
        (logits [B, N], feature maps)."""
        if self.use_cond:
            x = torch.cat([_cond_net_apply(params["cond"], mel, self.hop), x], dim=-1)
        B, T, C = x.shape
        x = x.transpose(1, 2)                                   # [B, C, T]
        p = self.period
        if T % p:
            x = F.pad(x, (0, p - T % p), mode="reflect")
        x = x.reshape(B, C, -1, p)                              # [B, C, T/p, p]
        fmap = []
        for i, c in enumerate(params["convs"]):
            x = conv2d(x, weight_norm_weight(c), c["b"], stride=(self.s if i < 4 else 1, 1),
                       padding=(2, 0))
            x = F.leaky_relu(x, LRELU)
            fmap.append(x)
        x = conv2d(x, weight_norm_weight(params["post"]), params["post"]["b"],
                   padding=(1, 0))
        fmap.append(x)
        return x.reshape(B, -1), fmap


class DiscriminatorS:
    """Scale discriminator: grouped strided 1-D convs (hifigan_causal.py:419-452).
    With ``use_spectral_norm`` (the full-rate scale) the weights are stored
    raw and spectral-normed at apply time; otherwise weight-normed."""

    # (in, out, k, stride, groups, pad)
    LAYERS = [(1, 128, 15, 1, 1, 7), (128, 128, 41, 2, 4, 20),
              (128, 256, 41, 2, 16, 20), (256, 512, 41, 4, 16, 20),
              (512, 1024, 41, 4, 16, 20), (1024, 1024, 41, 1, 16, 20),
              (1024, 1024, 5, 1, 1, 2)]

    def __init__(self, use_spectral_norm: bool = False, use_cond: bool = False,
                 up_t: int = 320):
        self.spectral = use_spectral_norm
        self.use_cond = use_cond
        self.up_t = up_t        # the cond upsampler's stride: hop / 2^scale
        if use_cond:
            self.LAYERS = [(2, *DiscriminatorS.LAYERS[0][1:]), *DiscriminatorS.LAYERS[1:]]

    def _conv_init(self, gen: torch.Generator, out_ch: int, in_ch: int, k: int) -> Params:
        if not self.spectral:
            return _wn_conv_init(gen, out_ch, in_ch, k)
        shape = (out_ch, in_ch, k)
        return {"w": inits.kaiming_uniform(gen, shape),
                "b": inits.default_bias(gen, (out_ch,), shape)}

    def _weight(self, c: Params) -> torch.Tensor:
        return spectral_norm_weight(c["w"]) if self.spectral else weight_norm_weight(c)

    def init(self, gen: torch.Generator) -> Params:
        p = {"convs": [self._conv_init(gen, co, ci // g, k)
                       for ci, co, k, s, g, pd in self.LAYERS],
             "post": self._conv_init(gen, 1, 1024, 3)}
        if self.use_cond:
            p["cond"] = _cond_net_init(gen, self.up_t)
        return p

    def forward(self, params: Params, x: torch.Tensor, mel: torch.Tensor | None = None):
        """x: [B, T, 1] (and the mel [B, T / up_t, 80] with ``use_cond``) →
        (logits [B, N], feature maps)."""
        if self.use_cond:
            x = torch.cat([_cond_net_apply(params["cond"], mel, self.up_t), x], dim=-1)
        fmap = []
        for (ci, co, k, s, g, pd), c in zip(self.LAYERS, params["convs"]):
            x = F.leaky_relu(conv1d(x, self._weight(c), c["b"], stride=s, padding=(pd, pd),
                                    groups=g), LRELU)
            fmap.append(x)
        x = conv1d(x, self._weight(params["post"]), params["post"]["b"], padding=(1, 1))
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


def _avg_pool1d(x: torch.Tensor) -> torch.Tensor:
    """torch AvgPool1d(4, 2, padding=1), count_include_pad=True, on [B, T, C]:
    the mean of each zero-padded window, taken by ``unfold``. Not
    ``F.avg_pool1d`` on the [B, 1, T] view: on the CUDA card its input
    gradient for a one-channel wav came out 69-76% off the CPU's in float64
    while its forward agreed, so the MSD's pooled scales sent the generator
    wrong gradients."""
    return F.pad(x, (0, 0, 1, 1)).unfold(1, 4, 2).mean(-1)


class _Multi:
    """Runs each sub-discriminator on its view of a wav batch."""

    discs: list

    def init(self, gen: torch.Generator) -> Params:
        return {"discs": [d.init(gen) for d in self.discs]}

    def _views(self, x: torch.Tensor):
        return [x] * len(self.discs)

    def forward(self, params: Params, x: torch.Tensor, mel: torch.Tensor | None = None):
        """One wav batch [B, T, 1] (and the conditioning mel) → (logits per
        disc, feature maps per disc)."""
        outs, fmaps = [], []
        for d, p, v in zip(self.discs, params["discs"], self._views(x)):
            o, f = d.forward(p, v, mel)
            outs.append(o)
            fmaps.append(f)
        return outs, fmaps

    def apply(self, params: Params, y: torch.Tensor, y_hat: torch.Tensor,
              mel: torch.Tensor | None = None):
        """(real logits, generated logits, real fmaps, generated fmaps), as the
        JAX package's ``apply``."""
        y_d_rs, fmap_rs = self.forward(params, y, mel)
        y_d_gs, fmap_gs = self.forward(params, y_hat, mel)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class MultiPeriodDiscriminator(_Multi):
    PERIODS = (2, 3, 5, 7, 11)

    def __init__(self, use_cond: bool = False, hop: int = 320):
        self.discs = [DiscriminatorP(p, use_cond=use_cond, hop=hop) for p in self.PERIODS]


class MultiScaleDiscriminator(_Multi):
    """Three scales: the full-rate wav, spectral-normed (hifigan_causal.py:460),
    then twice average-pooled by 2; with ``use_cond`` each scale's mel
    upsampler strides hop / 2^scale, its wav's rate."""

    def __init__(self, use_cond: bool = False, hop: int = 320):
        self.discs = [DiscriminatorS(use_spectral_norm=True, use_cond=use_cond, up_t=hop),
                      DiscriminatorS(use_cond=use_cond, up_t=hop // 2),
                      DiscriminatorS(use_cond=use_cond, up_t=hop // 4)]

    def _views(self, x: torch.Tensor):
        views = [x]
        for _ in self.discs[1:]:
            views.append(_avg_pool1d(views[-1]))
        return views


# ---------------------------------------------------------------------------
# Multi-window mel discriminator (the Conan adversarial mel loss)
# ---------------------------------------------------------------------------

class SingleWindowDisc:
    """3 × [conv2d 3×3 stride 2 → leaky ReLU 0.2 → Dropout2d(0.25) → BN] (no
    BN after the last) + a linear head. BatchNorm uses the batch's statistics
    (population variance) with eps 0.8, the reference's positional eps."""

    BN_EPS = 0.8

    def __init__(self, time_length: int, freq_length: int = 80, hidden: int = 128):
        self.t, self.f, self.h = time_length, freq_length, hidden
        self.ds = (time_length // 8, (freq_length + 7) // 8)

    def init(self, gen: torch.Generator) -> Params:
        def conv(ci: int, co: int) -> Params:
            shape = (co, ci, 3, 3)
            return {"w": inits.kaiming_uniform(gen, shape),
                    "b": inits.default_bias(gen, (co,), shape)}

        bn = lambda: {"scale": torch.ones(self.h), "bias": torch.zeros(self.h)}  # noqa: E731
        return {"c0": conv(1, self.h), "c1": conv(self.h, self.h), "c2": conv(self.h, self.h),
                "bn0": bn(), "bn1": bn(),
                "out": init_linear(gen, 1, self.h * self.ds[0] * self.ds[1])}

    def _bn(self, x: torch.Tensor, p: Params) -> torch.Tensor:
        """Batch norm in training mode: the statistics of the global batch,
        summed across the ranks with the gradient under data parallelism."""
        n = x.numel() // x.shape[1] * dist.size()
        mu = dist.sum_across(x.sum(dim=(0, 2, 3), keepdim=True)) / n
        var = dist.sum_across(torch.square(x - mu).sum(dim=(0, 2, 3), keepdim=True)) / n
        return ((x - mu) * torch.rsqrt(var + self.BN_EPS) * p["scale"][:, None, None]
                + p["bias"][:, None, None])

    def apply(self, params: Params, x: torch.Tensor,
              generator: torch.Generator | None = None):
        """x: [B, 1, T_win, M] → (validity [B, 1], hidden maps [B, C, T', M'])."""
        hiddens = []
        for i, name in enumerate(("c0", "c1", "c2")):
            x = F.leaky_relu(conv2d(x, params[name]["w"], params[name]["b"], stride=2,
                                    padding=1), 0.2)
            if generator is not None:       # Dropout2d: whole channels
                keep = dist.rand((x.shape[0], x.shape[1], 1, 1), generator, x.device) < 0.75
                x = torch.where(keep, x / 0.75, 0.0)
            if i < 2:
                x = self._bn(x, params[f"bn{i}"])
            hiddens.append(x)
        return linear(x.reshape(x.shape[0], -1), params["out"]), hiddens


class MultiWindowDiscriminator:
    """Random crops of 32/64/128 frames, one SingleWindowDisc each, their
    validities summed."""

    def __init__(self, time_lengths=(32, 64, 128), freq_length: int = 80, hidden: int = 128):
        self.windows = tuple(time_lengths)
        self.discs = [SingleWindowDisc(t, freq_length, hidden) for t in self.windows]

    def init(self, gen: torch.Generator) -> Params:
        return {"discs": [d.init(gen) for d in self.discs]}

    def apply(self, params: Params, mel: torch.Tensor,
              generator: torch.Generator | None = None, *, start_frames=None):
        """mel [B, T, M] → (summed validity [B, 1], hidden maps, the crop
        starts used, fit). ``fit`` is a device bool, true only when every
        window engaged: a window longer than T never does, and one longer
        than the longest utterance (frames with any nonzero bin) does not;
        the caller gates the GAN losses on it, as the reference skips them.
        A crop starts at ``start_frames[i]`` where given, else uniformly in
        [0, max(len) - w] from ``generator`` (0 with no generator), clamped
        to [0, T - w] as a dynamic slice is."""
        B, T, _M = mel.shape
        max_len = dist.global_max((mel.abs().sum(-1) > 0).sum(-1).max())
        validity = torch.zeros(B, 1, device=mel.device, dtype=mel.dtype)
        hiddens, starts = [], []
        fit = torch.ones((), dtype=torch.bool, device=mel.device)
        for i, (w, d, p) in enumerate(zip(self.windows, self.discs, params["discs"])):
            if T < w:
                starts.append(None)
                fit = torch.zeros_like(fit)
                continue
            fit = fit & (max_len >= w)
            if start_frames is not None and start_frames[i] is not None:
                start = torch.as_tensor(start_frames[i], device=mel.device)
            elif generator is None:
                start = torch.zeros((), dtype=torch.long, device=mel.device)
            else:
                span = torch.clamp(max_len - w, min=0) + 1
                start = torch.floor(torch.rand((), generator=generator, device=mel.device)
                                    * span).long()
            start = torch.clamp(start, 0, T - w)
            starts.append(start)
            clip = mel[:, start + torch.arange(w, device=mel.device)]
            v, hs = d.apply(p, clip[:, None], generator)
            validity = validity + v
            hiddens.extend(hs)
        return validity, hiddens, starts, fit
