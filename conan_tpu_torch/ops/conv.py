"""1-D convolution primitives (``conan_tpu/ops/conv.py``).

Activations are channels-last ``[B, T, C]`` as in the JAX package; weights
are torch layout ``[out, in, k]``, which is also the JAX package's storage
layout, so checkpoints map one to one. Dense convs are plain ``F.conv1d``
calls on a transposed view, as the JAX package leaves them to XLA; grouped
convs (the MSD's) go through kernel K2 (``ops/groupconv.py``) on the card.
Every conv reads the training rung at call time (``ops/precision.py``):
under "default" it takes bf16-rounded operands, sums their exact products
in fp32 and returns fp32, as JAX's DEFAULT does. There a dense stride-1
``conv1d`` whose shape ``dense_kernel_takes`` runs K3
(``ops/denseconv.py``), and any other dense ``conv1d`` the fp32 conv of the
rounded operands (``rounded_dot``). ``conv2d`` and ``conv_transpose1d``
run K3 over a fold onto one stride-1 conv1d (``Conv2dFold``,
``ConvTranspose1dFold``: the same products, rearranged; the fold and its
adjoints inside K3's one autograd Function) where ``dense_kernel_takes``
the fold's conv1d, else ``rounded_dot`` of the op itself.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from conan_tpu_torch.ops.denseconv import dense_kernel_takes, denseconv
from conan_tpu_torch.ops.groupconv import groupconv
from conan_tpu_torch.ops.precision import bf16_dots, rounded_dot


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int | tuple[int, int] = 1,
           padding: int | tuple[int, int] = 0) -> torch.Tensor:
    """``F.conv2d`` in NCHW at the training rung: under "default" K3 over
    ``conv2d_fold``'s fold where ``dense_kernel_takes`` its conv1d, its
    result an NCHW view of the conv1d's channels-last rows; else
    ``rounded_dot`` (fp32 cuDNN on the rounded operands, TF32 off)."""
    if not bf16_dots():
        return F.conv2d(x, w, b, stride=stride, padding=padding)
    fold = conv2d_fold(tuple(x.shape), tuple(w.shape), _pair(stride), _pair(padding))
    if dense_kernel_takes(*fold.geometry):
        return denseconv(x, w, b, dilation=fold.Wo, fold=fold)
    y = rounded_dot(functools.partial(F.conv2d, stride=stride, padding=padding), x, w)
    return y if b is None else y + b[:, None, None]


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2dFold(NamedTuple):
    """``F.conv2d`` of x [B, C, H, W] and w [Co, C, kh, kw] at stride (sh,
    sw), padding (ph, pw), as one stride-1 conv1d at dilation Wo and no
    padding (K3 over ``x(x)`` and ``w(w)``, ``denseconv(..., fold=)``).
    Time is the output's (row, column) grid, Ho·Wo rows: the stride's sh·sw
    phases of the padded input and its qw = ceil(kw / sw) column taps go
    into channels (``channels`` = qw·sh·sw·C, in that order), and the qh =
    ceil(kh / sh) row taps are the conv1d's taps at dilation Wo; the weights
    of the taps past (kh, kw) are zero. A (k, 1) conv over the MPD's [T/p,
    p] is thus a conv over the wav's time at dilation p. ``y`` returns the
    conv1d's rows [B, Ho·Wo, Co] as an NCHW view; ``gy``, ``dx`` and ``dw``
    are the adjoints of ``y``, ``x`` and ``w``."""
    B: int
    C: int
    H: int
    W: int
    Co: int
    kh: int
    kw: int
    sh: int
    sw: int
    ph: int
    pw: int
    Ho: int
    Wo: int
    qh: int
    qw: int
    U: int              # phase rows and columns the output reads
    V: int

    @property
    def channels(self) -> int:
        return self.qw * self.sh * self.sw * self.C

    @property
    def geometry(self) -> tuple[int, int, int, int]:
        """The conv1d's (in channels, out channels, taps, dilation)."""
        return self.channels, self.Co, self.qh, self.Wo

    def _pads(self) -> tuple[int, ...]:
        """F.pad's pads of x [B, H, W, C] to [B, sh·U, sw·V, C]."""
        return (0, 0, self.pw, self.sw * self.V - self.W - self.pw,
                self.ph, self.sh * self.U - self.H - self.ph)

    def x(self, x: torch.Tensor) -> torch.Tensor:
        B, C, U, V, Wo, sh, sw = self.B, self.C, self.U, self.V, self.Wo, self.sh, self.sw
        xp = F.pad(x.permute(0, 2, 3, 1), self._pads())                # [B, sh·U, sw·V, C]
        z = xp.reshape(B, U, sh, V, sw, C).unfold(3, Wo, 1)    # [B, U, sh, qw, sw, C, Wo]
        return z.permute(0, 1, 6, 3, 2, 4, 5).reshape(B, U * Wo, self.channels)

    def dx(self, dx1: torch.Tensor) -> torch.Tensor:
        """Each column tap's part added back onto the columns it read."""
        B, C, U, Wo, qw, sh, sw = self.B, self.C, self.U, self.Wo, self.qw, self.sh, self.sw
        parts = dx1.reshape(B, U, Wo, qw, sh, sw, C).permute(0, 1, 4, 3, 2, 5, 6)
        dxp = F.pad(parts[:, :, :, 0], (0, 0, 0, 0, 0, qw - 1))    # [B, U, sh, V, sw, C]
        for j in range(1, qw):
            dxp[:, :, :, j:j + Wo] += parts[:, :, :, j]
        dxp = dxp.reshape(B, sh * U, sw * self.V, C)
        return F.pad(dxp, tuple(-p for p in self._pads())).permute(0, 3, 1, 2)

    def w(self, w: torch.Tensor) -> torch.Tensor:
        Co, C, qh, qw, sh, sw = self.Co, self.C, self.qh, self.qw, self.sh, self.sw
        wp = F.pad(w, (0, sw * qw - self.kw, 0, sh * qh - self.kh)).reshape(Co, C, qh, sh, qw, sw)
        return wp.permute(0, 4, 3, 5, 1, 2).reshape(Co, self.channels, qh)

    def dw(self, dw1: torch.Tensor) -> torch.Tensor:
        Co, C, qh, qw, sh, sw = self.Co, self.C, self.qh, self.qw, self.sh, self.sw
        d = dw1.reshape(Co, qw, sh, sw, C, qh).permute(0, 4, 5, 2, 1, 3)
        return d.reshape(Co, C, qh * sh, qw * sw)[:, :, :self.kh, :self.kw]

    def y(self, y1: torch.Tensor) -> torch.Tensor:
        return y1.reshape(self.B, self.Ho, self.Wo, self.Co).permute(0, 3, 1, 2)

    def gy(self, gy: torch.Tensor) -> torch.Tensor:
        return gy.permute(0, 2, 3, 1).reshape(self.B, self.Ho * self.Wo, self.Co)


@functools.lru_cache(maxsize=512)
def conv2d_fold(x_shape: tuple, w_shape: tuple, stride: tuple[int, int],
                padding: tuple[int, int]) -> Conv2dFold:
    """``Conv2dFold`` of one conv2d geometry."""
    B, C, H, W = x_shape
    Co, _, kh, kw = w_shape
    (sh, sw), (ph, pw) = stride, padding
    Ho, Wo = (H + 2 * ph - kh) // sh + 1, (W + 2 * pw - kw) // sw + 1
    qh, qw = -(-kh // sh), -(-kw // sw)
    return Conv2dFold(B, C, H, W, Co, kh, kw, sh, sw, ph, pw, Ho, Wo, qh, qw, Ho + qh - 1,
                      Wo + qw - 1)


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
    if bf16_dots() and stride == 1 and dense_kernel_takes(x.shape[-1], w.shape[0], w.shape[-1],
                                                          dilation):
        return denseconv(x, w, b, dilation=dilation, padding=tuple(padding))
    y = x.transpose(1, 2)
    if padding[0] or padding[1]:
        y = F.pad(y, tuple(padding))
    if not bf16_dots():
        return F.conv1d(y, w, b, stride=stride, dilation=dilation).transpose(1, 2)
    y = rounded_dot(functools.partial(F.conv1d, stride=stride, dilation=dilation), y, w)
    y = y.transpose(1, 2)
    return y if b is None else y + b


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                     stride: int, padding: int = 0, output_padding: int = 0) -> torch.Tensor:
    """torch's ConvTranspose1d at the training rung. x: [B, T, Cin], w: [Cin,
    Cout, K] → [B, (T-1)·stride - 2·padding + K + output_padding, Cout].
    Under "default" K3 over ``conv_transpose1d_fold``'s fold where
    ``dense_kernel_takes`` its conv1d, else ``rounded_dot``."""
    if not bf16_dots():
        return F.conv_transpose1d(x.transpose(1, 2), w, b, stride=stride, padding=padding,
                                  output_padding=output_padding).transpose(1, 2)
    fold = conv_transpose1d_fold(tuple(x.shape), tuple(w.shape), stride, padding,
                                 output_padding)
    if dense_kernel_takes(*fold.geometry):
        return denseconv(x, w, None if b is None else b.repeat_interleave(stride),
                         padding=fold.padding, fold=fold)
    y = rounded_dot(functools.partial(F.conv_transpose1d, stride=stride, padding=padding,
                                      output_padding=output_padding), x.transpose(1, 2), w)
    y = y.transpose(1, 2)
    return y if b is None else y + b


class ConvTranspose1dFold(NamedTuple):
    """torch's ConvTranspose1d of x [B, T, Cin] and w [Cin, Co, K] at stride
    u (``padding`` pad, L output rows) as one stride-1 conv1d of x itself
    with w(w) [Co·u, Cin, q = ceil(K/u)] (K3 over it, ``denseconv(...,
    fold=)``; the bias repeated u times). Output sample a·u + ρ of the full
    (untrimmed) transposed conv is channel o·u + ρ of the conv1d's row a,
    ``pixel_shuffle_1d(·, u)``'s order: phase ρ's taps are w[:, :, u·q' +
    ρ], flipped, zero past K, over x padded by q - 1 rows on the left; the
    right padding gives at least ``rows`` rows. ``y`` shuffles and trims;
    ``gy`` and ``dw`` are the adjoints of ``y`` and ``w``."""
    B: int
    T: int
    Cin: int
    Co: int
    K: int
    u: int
    q: int
    pad: int
    L: int
    rows: int

    @property
    def geometry(self) -> tuple[int, int, int, int]:
        """The conv1d's (in channels, out channels, taps, dilation)."""
        return self.Cin, self.Co * self.u, self.q, 1

    @property
    def padding(self) -> tuple[int, int]:
        return self.q - 1, max(self.rows - self.T, 0)

    def x(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def dx(self, dx1: torch.Tensor) -> torch.Tensor:
        return dx1

    def w(self, w: torch.Tensor) -> torch.Tensor:
        Cin, Co, q, u = self.Cin, self.Co, self.q, self.u
        w1 = F.pad(w, (0, u * q - self.K)).reshape(Cin, Co, q, u).flip(2).permute(1, 3, 0, 2)
        return w1.reshape(Co * u, Cin, q)

    def dw(self, dw1: torch.Tensor) -> torch.Tensor:
        Cin, Co, q, u = self.Cin, self.Co, self.q, self.u
        d = dw1.reshape(Co, u, Cin, q).permute(2, 0, 3, 1).flip(2)
        return d.reshape(Cin, Co, q * u)[:, :, :self.K]

    def y(self, y1: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle_1d(y1[:, :self.rows], self.u)[:, self.pad:self.pad + self.L]

    def gy(self, gy: torch.Tensor) -> torch.Tensor:
        B, Co, u, rows = self.B, self.Co, self.u, self.rows
        g = F.pad(gy, (0, 0, self.pad, rows * u - self.pad - self.L))      # [B, rows·u, Co]
        g = g.reshape(B, rows, u, Co).transpose(2, 3).reshape(B, rows, Co * u)
        return F.pad(g, (0, 0, 0, max(self.T, rows) - rows))


@functools.lru_cache(maxsize=512)
def conv_transpose1d_fold(x_shape: tuple, w_shape: tuple, u: int, pad: int,
                          output_padding: int) -> ConvTranspose1dFold:
    """``ConvTranspose1dFold`` of one transposed-conv geometry."""
    B, T, Cin = x_shape
    _, Co, K = w_shape
    L = (T - 1) * u - 2 * pad + K + output_padding
    return ConvTranspose1dFold(B, T, Cin, Co, K, u, -(-K // u), pad, L, -(-(L + pad) // u))


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
