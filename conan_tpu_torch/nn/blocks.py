"""Building blocks of the Conan acoustic model (``conan_tpu/nn/blocks.py``),
inference side: channels-last ``[B, T, C]``, parameters as trees of tensors.

  ConvBlocks / CausalConvBlocks   residual conv stacks (causal ones stream)
  WaveNet                         gated WN stack (the non-causal WN)
  PitchPredictor                  causal conv F0/UV head
  MultiheadAttention              nn.MultiheadAttention semantics
  positional_embedding            fairseq sinusoidal positions
  timestep_embedding              the flow denoiser's sinusoidal step embedding

In training, ``dropout`` draws its masks from a ``torch.Generator`` on the
tensors' device (not ``jax.random``'s stream); with no generator it is the
identity, as the JAX package's is with ``rng=None``. The modules that drop
(ConvBlocks, PitchPredictor, MultiheadAttention) take that generator.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from conan_tpu_torch.nn import inits
from conan_tpu_torch.nn.module import Params, Stream
from conan_tpu_torch.ops.conv import causal_conv1d_state, conv1d, weight_norm_weight
from conan_tpu_torch.ops.precision import bf16_dots, dot_at_rung, einsum_at_rung
from conan_tpu_torch.parallel import dist


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """LN over the channel (last) axis."""
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def init_layer_norm(dim: int) -> Params:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``F.linear`` at the training rung: under "default" ``x @ wᵀ``
    through ``dot_at_rung`` (bf16-rounded operands, an fp32 result) and the
    bias added in fp32 (``ops/precision.py``)."""
    if not bf16_dots():
        return F.linear(x, w, b)
    y = dot_at_rung(x, w.t())
    return y if b is None else y + b


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    return dense(x, p["w"], p.get("b"))


def init_linear(gen: torch.Generator, out_dim: int, in_dim: int) -> Params:
    """torch.nn.Linear's default init."""
    shape = (out_dim, in_dim)
    return {"w": inits.kaiming_uniform(gen, shape),
            "b": inits.default_bias(gen, (out_dim,), shape)}


def embedding(ids: torch.Tensor, p: Params) -> torch.Tensor:
    return F.embedding(ids, p["w"])


def init_embedding(gen: torch.Generator, num: int, dim: int,
                   padding_idx: int | None = None, *, std: float | None = None) -> Params:
    """N(0, dim^-0.5) by default (std=1.0 for a plain nn.Embedding), pad row zeroed."""
    w = inits.normal(gen, (num, dim), std=dim ** -0.5 if std is None else std)
    if padding_idx is not None:
        w[padding_idx] = 0.0
    return {"w": w}


def init_conv(gen: torch.Generator, out_ch: int, in_ch: int, k: int, *,
              init: str = "torch") -> Params:
    shape = (out_ch, in_ch, k)
    if init == "torch":
        w = inits.kaiming_uniform(gen, shape)
    elif init == "xavier":
        w = inits.xavier_uniform(gen, shape)
    elif init == "kaiming_relu":
        w = inits.kaiming_normal(gen, shape)
    else:
        raise ValueError(init)
    return {"w": w, "b": inits.default_bias(gen, (out_ch,), shape)}


def init_wn_conv(gen: torch.Generator, out_ch: int, in_ch: int, k: int, *,
                 std: float | None = None) -> Params:
    """Weight-normed conv {v, g, b}: v from torch's default init (or N(0, std)),
    g = ||v||."""
    p = init_conv(gen, out_ch, in_ch, k)
    v = inits.normal(gen, (out_ch, in_ch, k), std=std) if std is not None else p["w"]
    return {"v": v, "g": torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True)),
            "b": p["b"]}


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the rest by
    1 / (1 - rate), the mask drawn from ``generator``; the identity when
    ``generator`` is None or ``rate`` is 0."""
    if generator is None or rate == 0.0:
        return x
    keep = dist.rand(x.shape, generator, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def nonpadding_mask(x: torch.Tensor) -> torch.Tensor:
    """[B,T,C] → [B,T,1] float mask of frames with any nonzero channel."""
    return (torch.sum(torch.abs(x), dim=-1, keepdim=True) > 0).to(x.dtype)


# ---------------------------------------------------------------------------
# ConvBlocks / CausalConvBlocks
# ---------------------------------------------------------------------------

class ConvBlocks:
    """Stack of residual conv blocks (LN → conv ×2 width → GELU → 1×1 conv)
    + last LN + post-net conv; the Conan path's setting of the JAX package's
    ConvBlocks (LayerNorm, channel multiple 2, GELU).

    ``causal=True`` is CausalConvBlocks (left-padded convs, streams through a
    ``Stream``); ``causal=False`` pads symmetrically, for the encoders of the
    reference utterance, which is whole before streaming starts."""

    def __init__(self, hidden_size: int, out_dims: int, dilations, kernel_size: int,
                 *, layers_in_block: int = 2, num_layers: int | None = None,
                 post_net_kernel: int = 3, causal: bool = False, dropout: float = 0.0):
        if num_layers is not None:
            dilations = [1] * num_layers
        self.dropout = dropout
        self.hidden = hidden_size
        self.out_dims = out_dims
        self.dilations = tuple(dilations)
        self.k = kernel_size
        self.n = layers_in_block
        self.post_k = post_net_kernel
        self.causal = causal

    def init(self, gen: torch.Generator) -> Params:
        H = self.hidden
        blocks = [[{"norm": init_layer_norm(H),
                    "conv1": init_conv(gen, 2 * H, H, self.k, init="xavier"),
                    "conv2": init_conv(gen, H, 2 * H, 1, init="xavier")}
                   for _ in range(self.n)] for _ in self.dilations]
        return {"blocks": blocks, "last_norm": init_layer_norm(H),
                "post": init_conv(gen, self.out_dims, H, self.post_k, init="xavier")}

    def _conv(self, s: Stream, path: str, x: torch.Tensor, p: Params,
              dilation: int) -> torch.Tensor:
        if self.causal:
            return s.causal_conv(path, x, p, dilation=dilation, weight_norm=False)
        pad = (dilation * (p["w"].shape[-1] - 1)) // 2
        return conv1d(x, p["w"], p["b"], dilation=dilation, padding=(pad, pad))

    def apply(self, params: Params, x: torch.Tensor, nonpadding: torch.Tensor | None = None,
              *, stream: Stream | None = None,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """x: [B, T, H] → [B, T, out_dims]. With a ``generator`` (training),
        each block's output is dropped at the ``dropout`` rate."""
        s = stream or Stream(None)
        if nonpadding is None:
            nonpadding = torch.ones_like(x[..., :1]) if s.streaming else nonpadding_mask(x)
        for bi, (d, block) in enumerate(zip(self.dilations, params["blocks"])):
            for ni, sub in enumerate(block):
                h = self._conv(s, f"b{bi}.{ni}.c1", layer_norm(x, sub["norm"]), sub["conv1"], d)
                h = conv1d(F.gelu(h * (self.k ** -0.5)), sub["conv2"]["w"], sub["conv2"]["b"])
                x = (x + dropout(h, self.dropout, generator)) * nonpadding
        x = layer_norm(x, params["last_norm"]) * nonpadding
        return self._conv(s, "post", x, params["post"], 1) * nonpadding

    def init_state(self, batch: int, device: torch.device | str = "cpu") -> dict:
        if not self.causal:
            raise ValueError("only causal ConvBlocks stream")
        st = {f"b{bi}.{ni}.c1": causal_conv1d_state(batch, self.hidden, self.k, d,
                                                    device=device)
              for bi, d in enumerate(self.dilations) for ni in range(self.n)}
        st["post"] = causal_conv1d_state(batch, self.hidden, self.post_k, 1, device=device)
        return st


# ---------------------------------------------------------------------------
# WaveNet (WN, symmetric padding)
# ---------------------------------------------------------------------------

class WaveNet:
    """Gated WaveNet stack with weight-normed convs and symmetric padding (the
    reference WN). The causal variant serves the flow F0 path and waits."""

    def __init__(self, hidden_size: int, kernel_size: int, dilation_rate: int,
                 n_layers: int):
        if kernel_size % 2 != 1 or hidden_size % 2 != 0:
            raise ValueError("WaveNet needs an odd kernel and an even width")
        self.h = hidden_size
        self.k = kernel_size
        self.dr = dilation_rate
        self.n = n_layers

    def init(self, gen: torch.Generator) -> Params:
        p: Params = {"in": [], "res_skip": []}
        for i in range(self.n):
            p["in"].append(init_wn_conv(gen, 2 * self.h, self.h, self.k))
            out_ch = 2 * self.h if i < self.n - 1 else self.h
            p["res_skip"].append(init_wn_conv(gen, out_ch, self.h, 1))
        return p

    def apply(self, params: Params, x: torch.Tensor,
              nonpadding: torch.Tensor | None = None) -> torch.Tensor:
        """x: [B, T, H] → [B, T, H]."""
        np_ = nonpadding if nonpadding is not None else 1.0
        output = torch.zeros_like(x)
        for i in range(self.n):
            d = self.dr ** i
            p_in = params["in"][i]
            pad = (self.k * d - d) // 2
            x_in = conv1d(x, weight_norm_weight(p_in), p_in["b"], dilation=d,
                          padding=(pad, pad))
            acts = torch.tanh(x_in[..., :self.h]) * torch.sigmoid(x_in[..., self.h:])
            prs = params["res_skip"][i]
            res_skip = conv1d(acts, weight_norm_weight(prs), prs["b"])
            if i < self.n - 1:
                x = (x + res_skip[..., :self.h]) * np_
                output = output + res_skip[..., self.h:]
            else:
                output = output + res_skip
        return output * np_


# ---------------------------------------------------------------------------
# PitchPredictor (causal convs)
# ---------------------------------------------------------------------------

class PitchPredictor:
    P = 0.1     # dropout rate after each conv, in training

    def __init__(self, idim: int, n_layers: int = 5, n_chans: int = 384, odim: int = 2,
                 kernel_size: int = 5):
        self.idim, self.n, self.ch = idim, n_layers, n_chans
        self.odim, self.k = odim, kernel_size

    def init(self, gen: torch.Generator) -> Params:
        convs = [init_conv(gen, self.ch, self.idim if i == 0 else self.ch, self.k,
                           init="kaiming_relu") for i in range(self.n)]
        return {"convs": convs, "ln": init_layer_norm(self.ch),
                "out": init_linear(gen, self.odim, self.ch)}

    def apply(self, params: Params, x: torch.Tensor, *, stream: Stream | None = None,
              prefix: str = "pp", generator: torch.Generator | None = None) -> torch.Tensor:
        """x: [B, T, H] → [B, T, odim]; with a ``generator``, dropout after
        each conv."""
        s = stream or Stream(None)
        for i, c in enumerate(params["convs"]):
            x = F.relu(s.causal_conv(f"{prefix}.{i}", x, c, weight_norm=False))
            x = dropout(x, self.P, generator)
        return linear(layer_norm(x, params["ln"]), params["out"])

    def init_state(self, batch: int, prefix: str = "pp",
                   device: torch.device | str = "cpu") -> dict:
        return {f"{prefix}.{i}": causal_conv1d_state(batch, self.idim if i == 0 else self.ch,
                                                     self.k, 1, device=device)
                for i in range(self.n)}


# ---------------------------------------------------------------------------
# Sinusoidal positional embedding (fairseq style)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def sinusoidal_positions_table(num: int, dim: int, padding_idx: int = 0) -> np.ndarray:
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    emb = np.exp(np.arange(half) * -emb)
    emb = np.arange(num)[:, None] * emb[None, :]
    table = np.concatenate([np.sin(emb), np.cos(emb)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num, 1))], axis=1)
    table[padding_idx] = 0
    return table.astype(np.float32)


def positional_embedding(first_channel: torch.Tensor, dim: int, padding_idx: int = 0,
                         max_positions: int = 4000) -> torch.Tensor:
    """fairseq SinusoidalPositionalEmbedding.forward on a float "token" input:
    position = padding_idx + cumsum(x != padding_idx), pad rows zeroed.
    Positions past the table's last row read the last row, as the JAX
    package's gather clamps them (fairseq grows the table instead)."""
    mask = (first_channel != padding_idx).long()
    positions = torch.clamp(torch.cumsum(mask, dim=1) * mask + padding_idx,
                            max=max_positions - 1)
    table = torch.from_numpy(sinusoidal_positions_table(max_positions, dim, padding_idx))
    return F.embedding(positions, table.to(first_channel.device))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Diffusion SinusoidalPosEmb: t [N] steps → [N, dim] (sin ∥ cos). Built
    on ``t``'s device, so it runs inside a captured CUDA graph, where a copy
    from the host would fail the capture."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    emb = torch.exp(torch.arange(half, device=t.device) * -emb)
    emb = t[:, None].float() * emb[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


# ---------------------------------------------------------------------------
# torch-style MultiheadAttention (the prosody aligner's)
# ---------------------------------------------------------------------------

class MultiheadAttention:
    """nn.MultiheadAttention semantics (packed in-projection)."""

    P = 0.1     # dropout rate on the attention probabilities, in training

    def __init__(self, dim: int, num_heads: int):
        if dim % num_heads:
            raise ValueError(f"dim {dim} not a multiple of {num_heads} heads")
        self.dim, self.h = dim, num_heads

    def init(self, gen: torch.Generator) -> Params:
        return {"in_w": inits.xavier_uniform(gen, (3 * self.dim, self.dim)),
                "in_b": torch.zeros(3 * self.dim),
                "out": init_linear(gen, self.dim, self.dim)}

    def apply(self, params: Params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              key_padding_mask: torch.Tensor | None = None, *,
              generator: torch.Generator | None = None, need_weights: bool = False):
        """q: [B,Tq,D], k/v: [B,Tk,D]; key_padding_mask: [B,Tk] True=pad →
        [B,Tq,D], and with ``need_weights`` also the attention probabilities
        averaged over the heads [B,Tq,Tk]. With a ``generator``, dropout on
        the probabilities (the averaged ones are taken after it)."""
        D, H = self.dim, self.h
        Dh = D // H
        W, b = params["in_w"], params["in_b"]
        B, Tq, _ = q.shape
        Tk = k.shape[1]
        qh = dense(q, W[:D], b[:D]).reshape(B, Tq, H, Dh)
        kh = dense(k, W[D:2 * D], b[D:2 * D]).reshape(B, Tk, H, Dh)
        vh = dense(v, W[2 * D:], b[2 * D:]).reshape(B, Tk, H, Dh)
        logits = einsum_at_rung("bqhd,bkhd->bhqk", qh, kh) * (Dh ** -0.5)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
        probs = dropout(torch.softmax(logits, dim=-1), self.P, generator)
        o = linear(einsum_at_rung("bhqk,bkhd->bqhd", probs, vh).reshape(B, Tq, D),
                   params["out"])
        return (o, probs.mean(dim=1)) if need_weights else o
