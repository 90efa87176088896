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

The training rung (``ops/precision.py``) picks the route at call time. Under
"default" the forward is K2-bf16 (``groupconv_forward_bf16``): one bf16
product of bf16-rounded operands, fp32 accumulation, fp32 output, as the TPU
kernel computes when handed bf16 operands; its plain version is
``grouped_conv1d_reference`` on the rounded operands, in fp32; the backward
takes bf16-rounded operands too (``precision.bf16_dot``). Under "high" and
"highest" (and outside training) the forward is the 3xTF32 kernel, more
exact than "high" asks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from conan_tpu_torch.ops.precision import bf16_dot, bf16_dots


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


def kernel_weights_bf16(w: torch.Tensor, groups: int) -> torch.Tensor:
    """w [Co, cig, K] as K2-bf16 takes it: rounded to bf16 (nearest even) in
    [groups, K·cigp/16, cog, 16], the reduction r = j·cigp + ci in k-steps of
    16 channels of one tap, cigp = cig rounded up to 16 with zero channels
    (the mma's k is 16; the MSD's 128 → 256 layer has cig 8)."""
    Co, cig, K = w.shape
    cigp = -(-cig // 16) * 16
    wt = F.pad(w, (0, 0, 0, cigp - cig)).reshape(groups, Co // groups, cigp // 16, 16, K)
    return (wt.permute(0, 4, 2, 1, 3).reshape(groups, K * cigp // 16, Co // groups, 16)
            .to(torch.bfloat16).contiguous())


def grouped_conv1d_bf16_reference(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                                  padding: tuple[int, int] = (0, 0),
                                  groups: int) -> torch.Tensor:
    """K2-bf16's plain version: the fp32 grouped conv of the bf16-rounded
    operands."""
    rnd = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    return grouped_conv1d_reference(rnd(x), rnd(w), stride=stride, padding=padding,
                                    groups=groups)


class GroupConvKernel:
    """Wrapper of the CUDA kernels: checks its inputs, splits and regroups
    the weights (``kernel_weights``, or ``kernel_weights_bf16`` for K2-bf16),
    allocates the output, launches on the current stream and counts the
    launches of each kernel, ``launches`` (3xTF32) and ``launches_bf16``."""

    def __init__(self):
        self.launches = 0
        self.launches_bf16 = 0

    def launch(self, x: torch.Tensor, w: torch.Tensor, *, stride: int,
               padding: tuple[int, int], groups: int, bf16: bool = False) -> torch.Tensor:
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
        y = torch.empty(B, T_out, Co, device=x.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            if bf16:
                wq = kernel_weights_bf16(w, groups)
                err = lib.groupconv_forward_bf16(x.data_ptr(), wq.data_ptr(), y.data_ptr(), B,
                                                 T, Ci, T_out, Co, groups, K, stride,
                                                 padding[0], stream)
            else:
                w_hi, w_lo = kernel_weights(w, groups)
                err = lib.groupconv_forward(x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
                                            y.data_ptr(), B, T, Ci, T_out, Co, groups, K,
                                            stride, padding[0], stream)
        if err != 0:
            raise RuntimeError(f"groupconv{'_bf16' if bf16 else ''} kernel launch failed: "
                               f"cudaError {err}")
        if bf16:
            self.launches_bf16 += 1
        else:
            self.launches += 1
        return y

    def __call__(self, x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 padding: tuple[int, int] = (0, 0), groups: int) -> torch.Tensor:
        """x [B, T, Ci], w [Co, Ci/groups, K] → [B, T_out, Co], no bias."""
        return _GroupConvFunction.apply(x, w, stride, tuple(padding), groups, self)


class _GroupConvFunction(torch.autograd.Function):
    """Forward: K2 (3xTF32, or K2-bf16 under the "default" rung) on a CUDA
    tensor, the matching plain forward on a CPU one. Backward: plain torch,
    the same on both, with bf16-rounded operands under "default"."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups, kernel):
        ctx.save_for_backward(x, w)
        ctx.conv = dict(stride=stride, groups=groups)
        ctx.padding = padding
        ctx.bf16 = bf16_dots()
        if x.device.type == "cpu":
            ref = grouped_conv1d_bf16_reference if ctx.bf16 else grouped_conv1d_reference
            return ref(x, w, padding=padding, **ctx.conv)
        return kernel.launch(x, w, padding=padding, bf16=ctx.bf16, **ctx.conv)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        pl, pr = ctx.padding
        xp = F.pad(x.transpose(1, 2), (pl, pr))                     # [B, Ci, T + pl + pr]
        gy = gy.transpose(1, 2)                                     # [B, Co, T_out]
        dot = bf16_dot if ctx.bf16 else (lambda fn, *ops: fn(*ops))
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dxp = dot(lambda w_, g_: torch.nn.grad.conv1d_input(xp.shape, w_, g_, **ctx.conv),
                      w, gy)
            dx = dxp[:, :, pl:pl + x.shape[1]].transpose(1, 2)
        if ctx.needs_input_grad[1]:
            dw = dot(lambda x_, g_: torch.nn.grad.conv1d_weight(x_, w.shape, g_, **ctx.conv),
                     xp, gy)
        return dx, dw, None, None, None, None


groupconv = GroupConvKernel()
