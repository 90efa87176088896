"""Strided grouped 1-D convolution: kernel K2 and its plain version.

``groupconv`` is the counterpart of
``conan_tpu/ops/pallas_groupconv.py:pallas_grouped_conv1d``, the MSD's
grouped convs. On a CUDA tensor its forward launches the hand-written kernel
in ``csrc/groupconv.cu``, an implicit GEMM on the tensor cores at fp32
accuracy (the three-product tf32 split, whose weight half ``tf32_split``
makes here); its backward (dx and dw) is plain torch
(``torch.nn.grad.conv1d_input`` / ``conv1d_weight``), the counterpart of the
JAX package's XLA VJP (``pallas_groupconv.py:151-158``), and computes only
the gradients asked for. On a CPU tensor the forward runs the plain version,
``grouped_conv1d_reference``, under the same backward. There is no other
route: any other device raises. Layouts are the JAX package's: x [B, T, Ci]
channels-last, w [Co, Ci/groups, K], y [B, T_out, Co]. Dilation is 1: the
MSD, the only caller, dilates nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grouped_conv1d_reference(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                             padding: tuple[int, int] = (0, 0), groups: int) -> torch.Tensor:
    """Plain version: ``F.conv1d(groups=groups)`` on the channels-first view."""
    y = F.conv1d(F.pad(x.transpose(1, 2), tuple(padding)), w, stride=stride, groups=groups)
    return y.transpose(1, 2)


def tf32_split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``w`` as hi + lo, each a tf32 value (the low 13 mantissa bits
    zero): hi = tf32(w), lo = tf32(w - hi), rounded to nearest with ties away
    from zero on the fp32 bits, as the card's ``cvt.rna.tf32.f32`` rounds.
    hi + lo is w to about 2^-22 of |w|."""

    def tf32(v: torch.Tensor) -> torch.Tensor:
        return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    w = w.contiguous()
    hi = tf32(w)
    return hi, tf32(w - hi)


def kernel_weights(w: torch.Tensor, groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """w [Co, cig, K] as the kernel takes it: [groups, K·cig/8, cog, 8], the
    reduction r = j·cig + ci in k-steps of 8 (k-step r // 8, lane r % 8) with
    each k-step's out-channels contiguous, then split into (hi, lo)."""
    Co, cig, K = w.shape
    wt = w.reshape(groups, Co // groups, cig // 8, 8, K).permute(0, 4, 2, 1, 3)
    return tf32_split(wt.reshape(groups, K * cig // 8, Co // groups, 8))


class GroupConvKernel:
    """Wrapper of the CUDA kernel: checks its inputs, splits and regroups the
    weights (``kernel_weights``), allocates the output, launches on the
    current stream and counts its launches in ``launches``."""

    def __init__(self):
        self.launches = 0

    def launch(self, x: torch.Tensor, w: torch.Tensor, *, stride: int,
               padding: tuple[int, int], groups: int) -> torch.Tensor:
        if x.device.type != "cuda" or w.device != x.device:
            raise ValueError(f"groupconv: no kernel for x on {x.device}, w on {w.device}")
        if x.dtype != torch.float32 or w.dtype != torch.float32:
            raise TypeError(f"groupconv: x and w must be float32, got {x.dtype}, {w.dtype}")
        if x.dim() != 3 or w.dim() != 3 or not x.is_contiguous() or x.shape[0] == 0:
            raise ValueError(f"groupconv: x must be a contiguous non-empty [B, T, Ci] and "
                             f"w a [Co, Ci/groups, K], got {tuple(x.shape)}, {tuple(w.shape)}")
        B, T, Ci = x.shape
        Co, cig, K = w.shape
        if groups < 2 or Ci % groups or Co % groups or cig * groups != Ci:
            raise ValueError(f"groupconv: {groups} groups do not split Ci {Ci} and Co {Co} "
                             f"with w {tuple(w.shape)}")
        if cig % 8 or (Co // groups) % 8:
            raise ValueError(f"groupconv: channels per group {cig} in, {Co // groups} out "
                             f"are not multiples of 8")
        if stride < 1 or min(padding) < 0:
            raise ValueError(f"groupconv: stride {stride}, padding {padding}")
        T_out = (T + padding[0] + padding[1] - K) // stride + 1
        if T_out < 1:
            raise ValueError(f"groupconv: {T} samples give no output for K {K}")
        from conan_tpu_torch.ops import native

        lib = native.load()
        if x.data_ptr() % 16:      # the kernel copies x in 16-byte chunks
            x = x.clone()
        w_hi, w_lo = kernel_weights(w, groups)
        y = torch.empty(B, T_out, Co, device=x.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            err = lib.groupconv_forward(x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
                                        y.data_ptr(), B, T, Ci, T_out, Co, groups, K, stride,
                                        padding[0], stream)
        if err != 0:
            raise RuntimeError(f"groupconv kernel launch failed: cudaError {err}")
        self.launches += 1
        return y

    def __call__(self, x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 padding: tuple[int, int] = (0, 0), groups: int) -> torch.Tensor:
        """x [B, T, Ci], w [Co, Ci/groups, K] → [B, T_out, Co], no bias."""
        return _GroupConvFunction.apply(x, w, stride, tuple(padding), groups, self)


class _GroupConvFunction(torch.autograd.Function):
    """Forward: K2 on a CUDA tensor, the plain forward on a CPU one.
    Backward: plain torch, the same on both."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups, kernel):
        ctx.save_for_backward(x, w)
        ctx.conv = dict(stride=stride, groups=groups)
        ctx.padding = padding
        if x.device.type == "cpu":
            return grouped_conv1d_reference(x, w, padding=padding, **ctx.conv)
        return kernel.launch(x, w, padding=padding, **ctx.conv)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        pl, pr = ctx.padding
        xp = F.pad(x.transpose(1, 2), (pl, pr))                     # [B, Ci, T + pl + pr]
        gy = gy.transpose(1, 2)                                     # [B, Co, T_out]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxp = torch.nn.grad.conv1d_input(xp.shape, w, gy, **ctx.conv)
            dx = dxp[:, :, pl:pl + x.shape[1]].transpose(1, 2)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv1d_weight(xp, w.shape, gy, **ctx.conv)
        return dx, dw, None, None, None, None


groupconv = GroupConvKernel()
