"""Causal shuffle HiFi-GAN generator (``conan_tpu/models/vocoder/hifigan.py``).

mel [B, T, 80] → waveform [B, T·prod(strides), 1] at 16 kHz (total stride 320
= one mel hop). Every conv is causal (left-padded, weight-normed); upsampling
is a causal conv + 1-D pixel shuffle ("shuffle"), zero insertion + causal
conv ("zero"), or a transposed conv trimmed on the left ("nn"). Resblock "1"
is two causal convs per dilation, resblock "2" one. Offline and streaming
share one code path through ``Stream``, so a chunk's output equals the
matching slice of the offline output. "nn" is offline only: its output
sample m reads up to ⌈(k-1)/u⌉ frames past its own, so a chunk's output is
not a prefix of the offline output, and ``init_state`` refuses it as the JAX
package does (``conan_tpu/models/vocoder/hifigan.py:140-148``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from conan_tpu_torch.checkpoint import params_from_state_dict, state_dict_from_params
from conan_tpu_torch.nn import inits
from conan_tpu_torch.nn.blocks import init_wn_conv
from conan_tpu_torch.nn.module import Params, State, Stream
from conan_tpu_torch.ops.conv import (causal_conv1d_state, conv_transpose1d, pixel_shuffle_1d,
                                      weight_norm_weight)

LRELU_SLOPE = 0.1


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


@dataclasses.dataclass(frozen=True)
class HifiGanConfig:
    num_mels: int = 80
    upsample_initial_channel: int = 512
    upsample_rates: tuple[int, ...] = (8, 5, 4, 2)
    upsample_kernel_sizes: tuple[int, ...] = (16, 10, 8, 4)
    resblock: str = "1"
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample: str = "shuffle"  # shuffle | zero | nn

    @property
    def total_stride(self) -> int:
        s = 1
        for u in self.upsample_rates:
            s *= u
        return s

    @classmethod
    def from_hparams(cls, hp) -> "HifiGanConfig":
        return cls(
            num_mels=hp.get("num_mels", hp.get("audio_num_mel_bins", 80)),
            upsample_initial_channel=hp.get("upsample_initial_channel", 512),
            upsample_rates=tuple(hp["upsample_rates"]),
            upsample_kernel_sizes=tuple(hp["upsample_kernel_sizes"]),
            resblock=str(hp.get("resblock", "1")),
            resblock_kernel_sizes=tuple(hp["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(tuple(d) for d in hp["resblock_dilation_sizes"]),
            upsample=hp.get("upsample", "shuffle"),
        )


def init_wn_deconv(gen: torch.Generator, in_ch: int, out_ch: int, k: int) -> Params:
    """Weight-normed transposed conv {v [in, out, k] ~ N(0, 0.01), g, b}; the
    bias takes torch's default bound for a conv of (out, in, k)."""
    v = inits.normal(gen, (in_ch, out_ch, k), std=0.01)
    return {"v": v, "g": torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True)),
            "b": inits.default_bias(gen, (out_ch,), (out_ch, in_ch, k))}


def init_resblocks(gen: torch.Generator, cfg: HifiGanConfig, ch: int) -> list:
    """One stage's resblocks: per kernel size, "1" has convs1 and convs2 (one
    per dilation each), "2" has convs."""
    def wn(k):
        return init_wn_conv(gen, ch, ch, k, std=0.01)

    if cfg.resblock == "1":
        return [{"convs1": [wn(rk) for _ in rd], "convs2": [wn(rk) for _ in rd]}
                for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)]
    return [{"convs": [wn(rk) for _ in rd]}
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)]


def wn_names(prefix: str) -> Params:
    """A weight-normed conv's state-dict keys (``checkpoint.py``)."""
    return {"v": f"{prefix}.weight_v", "g": f"{prefix}.weight_g", "b": f"{prefix}.bias"}


def resblock_names(cfg: HifiGanConfig, suffix: str = "") -> list:
    """``resblocks.{i}.convs{1,2}.{j}`` (resblock "1") or ``.convs.{j}``
    ("2") for every stage's blocks, each conv's own prefix ending in
    ``suffix``."""
    out = []
    for i in range(len(cfg.upsample_rates) * len(cfg.resblock_kernel_sizes)):
        nd = len(cfg.resblock_dilation_sizes[i % len(cfg.resblock_dilation_sizes)])
        convs = ("convs1", "convs2") if cfg.resblock == "1" else ("convs",)
        out.append({c: [wn_names(f"resblocks.{i}.{c}.{j}{suffix}") for j in range(nd)]
                    for c in convs})
    return out


def check_config(cfg: HifiGanConfig) -> None:
    if cfg.upsample not in ("shuffle", "zero", "nn"):
        raise ValueError(f"upsample {cfg.upsample!r} is not one of shuffle, zero, nn")
    if cfg.resblock not in ("1", "2"):
        raise ValueError(f"resblock {cfg.resblock!r} is not '1' or '2'")


class HifiGanGenerator:
    def __init__(self, cfg: HifiGanConfig):
        check_config(cfg)
        self.cfg = cfg
        # per-stage channel plan: 512 -> 256 -> 128 -> 64 -> 32
        chs = [cfg.upsample_initial_channel]
        for _ in cfg.upsample_rates:
            chs.append(chs[-1] // 2)
        self.channels = chs

    # ----------------------------------------------------------- params
    def init(self, gen: torch.Generator) -> Params:
        """Random parameters: weight-normed convs with v ~ N(0, 0.01)."""
        cfg = self.cfg

        def wn(o, i, k):
            return init_wn_conv(gen, o, i, k, std=0.01)

        ups, resblocks = [], []
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            cin, cout = self.channels[i], self.channels[i + 1]
            if cfg.upsample == "nn":
                ups.append({"deconv": init_wn_deconv(gen, cin, cout, k)})
            else:
                ups.append({"conv": wn(cout * u if cfg.upsample == "shuffle" else cout, cin, k)})
            resblocks += init_resblocks(gen, cfg, cout)
        return {"conv_pre": wn(cfg.upsample_initial_channel, cfg.num_mels, 7),
                "ups": ups, "resblocks": resblocks,
                "conv_post": wn(1, self.channels[-1], 7)}

    # ----------------------------------------------------------- torch import
    def torch_names(self) -> Params:
        """The reference HifiGanGenerator's (hifigan_causal.py) key of each
        leaf: conv_pre.conv, ups.{i}.conv.conv (shuffle, zero) or
        ups.{i}.deconv (nn), resblocks.{i}.convs{1,2}.{j}.conv, conv_post.conv."""
        cfg = self.cfg
        ups = [{"deconv": wn_names(f"ups.{i}.deconv")} if cfg.upsample == "nn"
               else {"conv": wn_names(f"ups.{i}.conv.conv")}
               for i in range(len(cfg.upsample_rates))]
        return {"conv_pre": wn_names("conv_pre.conv"), "ups": ups,
                "resblocks": resblock_names(cfg, ".conv"), "conv_post": wn_names("conv_post.conv")}

    def params_from_torch(self, sd, device=None) -> Params:
        """A reference state dict (tensors or numpy arrays) → params on
        ``device`` (None: the card)."""
        return params_from_state_dict(sd, self.torch_names(), device)

    def params_to_torch(self, params: Params) -> dict[str, torch.Tensor]:
        return state_dict_from_params(params, self.torch_names())

    # ----------------------------------------------------------- state
    def init_state(self, batch: int, device: torch.device | str = "cpu") -> State:
        """Zero carries for every causal conv (zeros are the offline forward's
        implicit left padding, so streaming ≡ offline exactly). The "zero"
        upsampler's carry lives at the upsampled rate. Raises
        NotImplementedError for "nn", which cannot stream."""
        cfg = self.cfg
        if cfg.upsample == "nn":
            raise NotImplementedError(
                "upsample='nn' is not prefix-consistent (transposed-conv outputs depend on "
                "future input frames); streaming is only defined for 'shuffle' and 'zero'")
        st: State = {"conv_pre": causal_conv1d_state(batch, cfg.num_mels, 7, device=device)}
        rb_idx = 0
        for i, k in enumerate(cfg.upsample_kernel_sizes):
            cout = self.channels[i + 1]
            st[f"ups.{i}"] = causal_conv1d_state(batch, self.channels[i], k, device=device)
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                for j, d in enumerate(rd):
                    if cfg.resblock == "1":
                        st[f"rb.{rb_idx}.c1.{j}"] = causal_conv1d_state(batch, cout, rk, d,
                                                                        device=device)
                        st[f"rb.{rb_idx}.c2.{j}"] = causal_conv1d_state(batch, cout, rk, 1,
                                                                        device=device)
                    else:
                        st[f"rb.{rb_idx}.c.{j}"] = causal_conv1d_state(batch, cout, rk, d,
                                                                       device=device)
                rb_idx += 1
        st["conv_post"] = causal_conv1d_state(batch, self.channels[-1], 7, device=device)
        return st

    # ----------------------------------------------------------- forward
    def _resblock(self, s: Stream, path: str, p: Params, x: torch.Tensor,
                  dilations: tuple[int, ...]) -> torch.Tensor:
        for j, d in enumerate(dilations):
            if self.cfg.resblock == "1":
                xt = s.causal_conv(f"{path}.c1.{j}", _lrelu(x), p["convs1"][j], dilation=d)
                x = x + s.causal_conv(f"{path}.c2.{j}", _lrelu(xt), p["convs2"][j])
            else:
                x = x + s.causal_conv(f"{path}.c.{j}", _lrelu(x), p["convs"][j], dilation=d)
        return x

    def _upsample(self, s: Stream, i: int, p: Params, x: torch.Tensor) -> torch.Tensor:
        u = self.cfg.upsample_rates[i]
        if self.cfg.upsample == "shuffle":
            # causal conv (in -> out·u) + pixel shuffle
            return pixel_shuffle_1d(s.causal_conv(f"ups.{i}", x, p["conv"]), u)
        if self.cfg.upsample == "nn":
            # transposed conv over the input padded by k//2 - 1 frames on the
            # left, its first (k//2 - 1)·u + k - 1 samples trimmed
            # (hifigan_causal.py:60-141); offline only
            if s.streaming:
                raise NotImplementedError("upsample='nn' does not stream")
            k = self.cfg.upsample_kernel_sizes[i]
            P = k // 2 - 1
            y = conv_transpose1d(F.pad(x, (0, 0, P, 0)), weight_norm_weight(p["deconv"]),
                                 p["deconv"]["b"], stride=u, output_padding=u - 1)
            trim = P * u + k - 1
            return y[:, trim:trim + x.shape[1] * u]
        # "zero": insert u-1 zeros after each frame, then the causal conv
        B, T, C = x.shape
        up = torch.zeros(B, T, u, C, dtype=x.dtype, device=x.device)
        up[:, :, 0, :] = x
        return s.causal_conv(f"ups.{i}", up.reshape(B, T * u, C), p["conv"])

    def _forward(self, params: Params, x: torch.Tensor, s: Stream) -> torch.Tensor:
        cfg = self.cfg
        x = s.causal_conv("conv_pre", x, params["conv_pre"])
        n_rb = len(cfg.resblock_kernel_sizes)
        rb_idx = 0
        for i in range(len(cfg.upsample_rates)):
            x = self._upsample(s, i, params["ups"][i], _lrelu(x))
            xs = None
            for _ in range(n_rb):
                y = self._resblock(s, f"rb.{rb_idx}", params["resblocks"][rb_idx], x,
                                   cfg.resblock_dilation_sizes[rb_idx % n_rb])
                xs = y if xs is None else xs + y
                rb_idx += 1
            x = xs / n_rb
        x = s.causal_conv("conv_post", _lrelu(x), params["conv_post"])
        return torch.tanh(x)

    def apply(self, params: Params, mel: torch.Tensor) -> torch.Tensor:
        """Offline forward. mel [B, T, num_mels] → wav [B, T·stride, 1]."""
        return self._forward(params, mel, Stream(None))

    def step(self, params: Params, state: State, mel_chunk: torch.Tensor):
        """Streaming step. mel_chunk [B, Tc, num_mels] → (wav [B, Tc·stride, 1],
        state'), equal to the matching slice of ``apply``."""
        s = Stream(state)
        y = self._forward(params, mel_chunk, s)
        return y, s.new_state
