"""1-D convolution primitives (``conan_tpu/ops/conv.py``).

Activations are channels-last ``[B, T, C]`` as in the JAX package; weights
are torch layout ``[out, in, k]``, which is also the JAX package's storage
layout, so checkpoints map one to one. Dense convs are plain ``F.conv1d``
calls on a transposed view, as the JAX package leaves them to XLA; grouped
convs (the MSD's) go through kernel K2 (``ops/groupconv.py``) on the card.
Every conv reads the training rung at call time (``ops/precision.py``): under
"default" it takes bf16-rounded operands and adds its bias in fp32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from conan_tpu_torch.ops.groupconv import groupconv
from conan_tpu_torch.ops.precision import bf16_dot, bf16_dots


def _conv_at_rung(conv, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                  bias_shape: tuple) -> torch.Tensor:
    """``conv(x, w, b)`` (channels-first), or under the "default" rung the
    conv of bf16-rounded operands with the bias added in fp32."""
    if not bf16_dots():
        return conv(x, w, b)
    y = bf16_dot(conv, x, w)
    return y if b is None else y + b.reshape(bias_shape)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           **kw) -> torch.Tensor:
    """``F.conv2d`` in NCHW (``kw``: its stride and padding) at the training
    rung."""
    return _conv_at_rung(functools.partial(F.conv2d, **kw), x, w, b, (-1, 1, 1))


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1, dilation: int = 1, padding: tuple[int, int] = (0, 0),
           groups: int = 1) -> torch.Tensor:
    """1-D conv. x: [B,T,Cin], w: [Cout, Cin//groups, K] -> [B,T',Cout]."""
    if groups > 1:
        if dilation != 1:
            raise NotImplementedError("grouped conv1d with dilation: the MSD, its only "
                                      "caller, dilates nothing")
        y = groupconv(x.contiguous(), w, stride=stride, padding=tuple(padding), groups=groups)
        return y if b is None else y + b
    y = x.transpose(1, 2)
    if padding[0] or padding[1]:
        y = F.pad(y, tuple(padding))
    y = _conv_at_rung(functools.partial(F.conv1d, stride=stride, dilation=dilation), y, w, b,
                      (-1, 1))
    return y.transpose(1, 2)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                  dilation: int = 1) -> torch.Tensor:
    """Left-padded causal conv: out[t] depends on in[<=t]. [B,T,C]->[B,T,O]."""
    left = dilation * (w.shape[-1] - 1)
    return conv1d(x, w, b, dilation=dilation, padding=(left, 0))


def causal_conv1d_state(batch: int, in_ch: int, k: int, dilation: int = 1, *,
                        device: torch.device | str = "cpu",
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Initial streaming carry: the ``dilation·(k-1)`` zero frames before t=0."""
    return torch.zeros(batch, dilation * (k - 1), in_ch, device=device, dtype=dtype)


def causal_conv1d_step(x: torch.Tensor, carry: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor | None = None, *, dilation: int = 1):
    """One streaming step; equals the matching slice of ``causal_conv1d`` over
    the whole sequence. x: [B, Tc, Cin]; carry: [B, dilation·(k-1), Cin] input
    tail. Returns ([B, Tc, Cout], new carry)."""
    left = dilation * (w.shape[-1] - 1)
    if left == 0:
        return conv1d(x, w, b), carry
    x_ext = torch.cat([carry.to(x.dtype), x], dim=1)
    y = conv1d(x_ext, w, b, dilation=dilation)
    return y, x_ext[:, x_ext.shape[1] - left:]


# ---------------------------------------------------------------------------
# Weight normalization (torch nn.utils.weight_norm, dim=0)
# ---------------------------------------------------------------------------

def weight_norm_weight(p: dict) -> torch.Tensor:
    """w = g · v / ||v|| per output channel; a pre-folded ``{"w": ...}`` (see
    ``fold_weight_norm``) is returned as it is."""
    if "w" in p:
        return p["w"]
    v, g = p["v"], p["g"]
    norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))
    return g * v / norm


def fold_weight_norm(params):
    """Fold every weight-normed dict {"v","g",...} of a parameter tree into
    {"w",...} once, for serving only (same arithmetic as the per-step
    recompose): training keeps (v, g), whose gradients are what weight norm
    changes."""
    if isinstance(params, dict):
        if "v" in params and "g" in params:
            out = {k: fold_weight_norm(params[k]) for k in params if k not in ("v", "g")}
            out["w"] = weight_norm_weight(params)
            return out
        return {k: fold_weight_norm(params[k]) for k in params}
    if isinstance(params, (list, tuple)):
        return type(params)(fold_weight_norm(x) for x in params)
    return params


def spectral_norm_weight(w: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """w / sigma_max(w), torch ``spectral_norm`` semantics without its buffer
    (``conan_tpu/ops/conv.py:218-240``): ``iters`` power iterations over the
    [out, in·k] matricization from the fixed start vector 1/sqrt(out); u and
    v carry no gradient, sigma = uᵀ W v differentiates through W."""
    m = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        u = torch.full((m.shape[0],), 1.0 / m.shape[0] ** 0.5, dtype=w.dtype, device=w.device)
        for _ in range(iters):
            v = m.T @ u
            v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
            u = m @ v
            u = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-12)
    sigma = u @ (m @ v)
    return w / torch.clamp(sigma, min=1e-12)


def pixel_shuffle_1d(x: torch.Tensor, r: int) -> torch.Tensor:
    """Channels-last 1-D pixel shuffle: [B, T, C*r] -> [B, T*r, C] with
    out[b, t*r + j, c] = x[b, t, c*r + j]."""
    B, T, CR = x.shape
    if CR % r:
        raise ValueError(f"channels {CR} not a multiple of {r}")
    C = CR // r
    return x.reshape(B, T, C, r).transpose(2, 3).reshape(B, T * r, C)
