"""Dense stride-1 1-D convolution at the "default" training rung: kernel K3,
its input and weight gradients, and their plain versions.

``denseconv`` is what ``ops.conv.conv1d`` runs under ``training_scope(
"default")`` for a dense (groups 1) stride-1 conv whose shape
``dense_kernel_takes`` (and ``conv2d`` / ``conv_transpose1d`` over their
folds onto such a conv): JAX's DEFAULT, bf16-rounded operands, exact
products summed in fp32, an fp32 result, for the forward and both
gradients. The JAX package leaves the conv to XLA
(``conan_tpu/ops/conv.py:68-76``); on the card cuDNN only returns a bf16
conv in bf16, so the port runs its own kernels there: on a CUDA tensor the
forward and dx launch K3 (``csrc/denseconv.cu``: a TMA-fed ``wgmma``
implicit GEMM whose A boxes are x's rows a tap at a time, the padding its
zero fill; dx is the same kernel over the flipped taps) and dw launches K3
dw (``csrc/denseconv_bwd.cu``: both operands read in place as MN-major
``wgmma`` operands, split partial sums added in a fixed order). x and the
incoming gradient are rounded to bf16 once a call here; the one C call
lays the weights out (``kernel_weights`` / ``kernel_weights_dx`` are that
layout's plain versions), encodes the tensor maps and launches. On a CPU
tensor each runs its plain version (``dense_conv1d_bf16_reference`` and
its ``_input_grad_`` / ``_weight_grad_`` kin: the fp32 conv, or its
backward conv, of the rounded operands, the values ``precision.
rounded_dot`` gives). There is no other route: a CUDA launch that fails
raises. Layouts are the JAX package's: x [B, T, Ci] channels-last, w [Co,
Ci, K], y [B, T_out, Co].
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from conan_tpu_torch.ops import native
from conan_tpu_torch.ops.groupconv import _current, sm_count

SLOT = 64               # output rows an m64 slot holds (csrc/denseconv.cu:kSlot)
CHUNK = 64              # input channels a reduction step (kChunk)
SMEM_LIMIT = 227 * 1024
# K3's tiles by output tile width BN: (NWG consumer warpgroups, stages), the
# instantiations csrc/denseconv.cu:DENSECONV_BUILT builds
DENSE_TILES = {128: (2, 4), 64: (2, 4)}
WGRAD_ROWS = 64         # rows of dw's reduction a chunk (csrc/denseconv_bwd.cu:kRows)
WGRAD_MAX_TPW = 4       # taps a warpgroup (DENSECONV_WGRAD_BUILT: 1-4)
WGRAD_MAX_WINDOW = 256  # x window rows a TMA box holds (kMaxWindow)
WGRAD_STAGES = 4
WGRAD_REDUCE_FLOATS = 48 * 1024 // 4   # one out-channel's C x K sums in shared memory


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _rnd(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16, in its own type (``precision.rounded_dot``'s
    rounding of a dot's operands)."""
    return t.to(torch.bfloat16).to(t.dtype)


class DensePlan(NamedTuple):
    """K3's tile for one (C in, N out) pair: ``args`` go to the C entry
    points; ``smem`` is a block's shared memory."""
    bn: int
    nwg: int
    stages: int
    smem: int

    @property
    def args(self) -> tuple[int, ...]:
        return tuple(self)[:3]


def _check_channels(what: str, Ci: int, Co: int, K: int, dilation: int) -> None:
    if Ci < 8 or Ci % 8 or Co < 8 or Co % 8:
        raise ValueError(f"{what}: {Ci} channels in, {Co} out (each a multiple of 8, at least "
                         f"8: TMA's 16-byte row stride)")
    if K < 1 or dilation < 1:
        raise ValueError(f"{what}: {K} taps at dilation {dilation}")


@functools.lru_cache(maxsize=512)
def dense_plan(C: int, N: int, K: int) -> DensePlan:
    """K3's plan for the conv of C input and N output channels (the input
    gradient's: C the forward's Co, N its Ci): the output tile width of 128
    or 64 that wastes fewer columns of N (128 on a tie), with DENSE_TILES'
    warpgroups and stages. Raises ValueError for what the kernel does not
    take."""
    _check_channels("denseconv", C, N, K, 1)
    bn = 128 if _round_up(N, 128) <= _round_up(N, 64) else 64
    nwg, stages = DENSE_TILES[bn]
    smem = 1024 + stages * (nwg * SLOT * CHUNK * 2 + bn * 128) + 16 * stages
    if smem > SMEM_LIMIT:
        raise ValueError(f"denseconv: {smem} bytes of shared memory")
    return DensePlan(bn, nwg, stages, smem)


class WgradTiles(NamedTuple):
    """K3 dw's tiling of one geometry: ``tpw`` taps a consumer warpgroup,
    ``nwg`` warpgroups (64 out-channels each), ``stages`` chunks in flight,
    ``win_rows`` x rows a chunk's window, ``runs`` runs of taps, ``smem``."""
    tpw: int
    nwg: int
    stages: int
    win_rows: int
    runs: int
    smem: int


@functools.lru_cache(maxsize=512)
def dense_wgrad_tiles(Ci: int, Co: int, K: int, dilation: int) -> WgradTiles:
    """K3 dw's tiles: min(K, WGRAD_MAX_TPW) taps a warpgroup, two
    warpgroups where Co is past 64, one else; the window of 64 rows and the
    run's taps. Raises ValueError for what the kernel does not take."""
    _check_channels("denseconv dw", Ci, Co, K, dilation)
    if Ci * K > WGRAD_REDUCE_FLOATS:
        raise ValueError(f"denseconv dw: an out-channel's {Ci} x {K} sums past the reduction's "
                         f"48 KB")
    tpw = min(K, WGRAD_MAX_TPW)
    nwg = 2 if Co > 64 else 1
    win_rows = _round_up(WGRAD_ROWS + (tpw - 1) * dilation, 8)
    if win_rows > WGRAD_MAX_WINDOW:
        raise ValueError(f"denseconv dw: a window of {win_rows} rows (dilation {dilation}) "
                         f"past a TMA box's {WGRAD_MAX_WINDOW}")
    smem = 1024 + WGRAD_STAGES * (nwg * 8 * WGRAD_ROWS * 16 + 8 * win_rows * 16) + \
        16 * WGRAD_STAGES
    if smem > SMEM_LIMIT:
        raise ValueError(f"denseconv dw: {smem} bytes of shared memory")
    return WgradTiles(tpw, nwg, WGRAD_STAGES, win_rows, -(-K // tpw), smem)


class WgradPlan(NamedTuple):
    """K3 dw's plan: its tiles and ``splits`` ranges of the reduction's
    ``n_chunks`` 64-row chunks; ``args`` go to the C entry point, which
    checks them; the partial sums take ``part_floats`` of fp32 scratch."""
    tiles: WgradTiles
    splits: int
    n_chunks: int
    part_floats: int

    @property
    def args(self) -> tuple[int, ...]:
        t = self.tiles
        return (t.tpw, t.nwg, t.stages, t.win_rows, self.splits)


@functools.lru_cache(maxsize=512)
def dense_wgrad_plan(B: int, T_out: int, Ci: int, Co: int, K: int, dilation: int,
                     sms: int) -> WgradPlan:
    """K3 dw's plan on a card of ``sms`` SMs: ``dense_wgrad_tiles``, and
    splits enough for two blocks an SM, at most one a chunk."""
    tiles = dense_wgrad_tiles(Ci, Co, K, dilation)
    n_chunks = B * -(-T_out // WGRAD_ROWS)
    base = -(-Ci // 64) * -(-Co // (64 * tiles.nwg)) * tiles.runs
    splits = max(1, min(n_chunks, -(-2 * sms // base)))
    return WgradPlan(tiles, splits, n_chunks, splits * K * Co * Ci)


def dense_kernel_takes(Ci: int, Co: int, K: int, dilation: int) -> bool:
    """Whether K3, its dx and its dw take a dense stride-1 conv of Ci
    input and Co output channels, K taps at ``dilation``: the route's one
    decision, from the shape alone (``ops.conv.conv1d``)."""
    try:
        dense_plan(Ci, Co, K)
        dense_plan(Co, Ci, K)
        dense_wgrad_tiles(Ci, Co, K, dilation)
    except ValueError:
        return False
    return True


def kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """w [N, C, K] as K3's TMA reads it, the plain version of the kernel's
    own preparation (``denseconv_weights_kernel``): rounded to bf16 (nearest
    even) in [N, K·Cp], out-channel n's reduction r = j·Cp + c contiguous,
    Cp = C rounded up to 64 with zero channels."""
    N, C, K = w.shape
    wt = F.pad(w, (0, 0, 0, _round_up(C, CHUNK) - C)).permute(0, 2, 1)      # [N, K, Cp]
    return wt.reshape(N, -1).to(torch.bfloat16).contiguous()


def kernel_weights_dx(w: torch.Tensor) -> torch.Tensor:
    """w [Co, Ci, K] as K3 reads it for the input gradient (the kernel's
    ``flip``): the weights of the conv of gy with the taps flipped and the
    channel roles swapped, [Ci, K·Cop] bf16."""
    return kernel_weights(w.flip(2).transpose(0, 1))


def dense_conv1d_bf16_reference(x: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor | None = None, *, dilation: int = 1,
                                padding: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """K3's plain version: the conv of the bf16-rounded x [B, T, Ci] and w
    in x's type (fp32 sums of the exact products, or float64), plus b."""
    y = F.conv1d(F.pad(_rnd(x).transpose(1, 2), tuple(padding)), _rnd(w), dilation=dilation)
    y = y.transpose(1, 2)
    return y if b is None else y + b


def dense_conv1d_bf16_input_grad_reference(gy: torch.Tensor, w: torch.Tensor, x_shape, *,
                                           dilation: int = 1,
                                           padding: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """K3 dx's plain version: ``conv1d_input`` in gy's type on the
    bf16-rounded w and gy [B, T_out, Co]; returns dx [B, T, Ci]."""
    B, T, Ci = x_shape
    pl, pr = padding
    dxp = torch.nn.grad.conv1d_input((B, Ci, T + pl + pr), _rnd(w), _rnd(gy).transpose(1, 2),
                                     dilation=dilation)
    return dxp[:, :, pl:pl + T].transpose(1, 2)


def dense_conv1d_bf16_weight_grad_reference(x: torch.Tensor, gy: torch.Tensor, w_shape, *,
                                            dilation: int = 1,
                                            padding: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """K3 dw's plain version: ``conv1d_weight`` in x's type on the
    bf16-rounded x [B, T, Ci] and gy [B, T_out, Co]; returns dw [Co, Ci, K]."""
    xp = F.pad(_rnd(x).transpose(1, 2), tuple(padding))
    return torch.nn.grad.conv1d_weight(xp, w_shape, _rnd(gy).transpose(1, 2), dilation=dilation)


def _bf16_operand(t: torch.Tensor, what: str) -> torch.Tensor:
    """A CUDA fp32 tensor rounded to bf16, contiguous from a 16-byte
    boundary, as the kernels' TMA reads it."""
    if t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 3:
        raise ValueError(f"denseconv {what}: no kernel for a {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    t = t.to(torch.bfloat16).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class DenseConvKernel:
    """Wrapper of the CUDA kernels: checks its inputs, allocates outputs and
    scratch, launches on the current stream and counts the launches of each
    kernel: ``launches`` (K3), ``launches_dx`` (K3 over the flipped taps)
    and ``launches_dw`` (K3 dw and its reduction)."""

    def __init__(self):
        self.launches = 0
        self.launches_dx = 0
        self.launches_dw = 0

    def _conv(self, xb: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, T_out: int,
              N: int, dilation: int, pad_l: int, flip: bool) -> torch.Tensor:
        """One C call: the conv of xb [B, T, C] bf16 with w laid out (flip:
        the input gradient's weights), into [B, T_out, N] fp32."""
        if xb.device.type != "cuda" or xb.dtype != torch.bfloat16 or not xb.is_contiguous() \
                or xb.data_ptr() % 16:
            raise ValueError(f"denseconv: the kernel reads a contiguous 16-byte-aligned bf16 "
                             f"CUDA input (_bf16_operand), got {xb.dtype} on {xb.device}")
        B, T, C = xb.shape
        K = w.shape[2]
        if w.device != xb.device or w.dtype != torch.float32 or (
                b is not None and (b.dtype != torch.float32 or b.shape != (N,))):
            raise ValueError(f"denseconv: w {w.dtype} on {w.device}, bias "
                             f"{None if b is None else (b.dtype, tuple(b.shape))}")
        if T_out < 1:
            raise ValueError(f"denseconv: {T} rows give no output for K {K} at dilation "
                             f"{dilation}")
        plan = dense_plan(C, N, K)
        lib = native.load()
        y = torch.empty(B, T_out, N, device=xb.device)
        wq = torch.empty(N, K * _round_up(C, CHUNK), dtype=torch.bfloat16, device=xb.device)
        with _current(xb.device):
            err = lib.denseconv_forward(
                xb.data_ptr(), w.contiguous().data_ptr(), wq.data_ptr(),
                None if b is None else b.contiguous().data_ptr(), y.data_ptr(), B, T, C, T_out,
                N, K, dilation, pad_l, int(flip), *plan.args,
                torch.cuda.current_stream(xb.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"denseconv{' dx' if flip else ''} kernel launch failed: "
                               f"cudaError {err}")
        return y

    def launch(self, xb: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *,
               dilation: int, padding: tuple[int, int]) -> torch.Tensor:
        """K3: xb [B, T, Ci] bf16 (``_bf16_operand``), w [Co, Ci, K] and b
        [Co] fp32 → y [B, T_out, Co] fp32."""
        Co, Ci, K = w.shape
        if xb.shape[2] != Ci:
            raise ValueError(f"denseconv: x {tuple(xb.shape)} against w {tuple(w.shape)}")
        T_out = xb.shape[1] + padding[0] + padding[1] - dilation * (K - 1)
        y = self._conv(xb, w, b, T_out, Co, dilation, padding[0], False)
        self.launches += 1
        return y

    def input_grad(self, gyb: torch.Tensor, w: torch.Tensor, x_shape, *, dilation: int,
                   padding: tuple[int, int]) -> torch.Tensor:
        """K3 dx: gyb [B, T_out, Co] bf16 and w → dx [B, T, Ci] fp32 for x
        of ``x_shape``: the conv of gy with the flipped taps, padded by
        dilation·(K-1) - pad_l on the left."""
        B, T, Ci = x_shape
        Co, _, K = w.shape
        if gyb.shape[0] != B or gyb.shape[2] != Co:
            raise ValueError(f"denseconv dx: gy {tuple(gyb.shape)} against x {tuple(x_shape)}, "
                             f"w {tuple(w.shape)}")
        dx = self._conv(gyb, w, None, T, Ci, dilation, dilation * (K - 1) - padding[0], True)
        self.launches_dx += 1
        return dx

    def weight_grad(self, xb: torch.Tensor, gyb: torch.Tensor, w_shape, *, dilation: int,
                    padding: tuple[int, int]) -> torch.Tensor:
        """K3 dw: xb [B, T, Ci] and gyb [B, T_out, Co] bf16 → dw of
        ``w_shape`` [Co, Ci, K] fp32."""
        Co, Ci, K = w_shape
        B, T, _ = xb.shape
        if xb.shape[2] != Ci or gyb.shape[0] != B or gyb.shape[2] != Co \
                or gyb.device != xb.device:
            raise ValueError(f"denseconv dw: x {tuple(xb.shape)}, gy {tuple(gyb.shape)} against "
                             f"w {tuple(w_shape)}")
        T_out = gyb.shape[1]
        plan = dense_wgrad_plan(B, T_out, Ci, Co, K, dilation, sm_count(xb.device.index))
        lib = native.load()
        dw = torch.empty(Co, Ci, K, device=xb.device)
        part = torch.empty(plan.part_floats, device=xb.device)
        with _current(xb.device):
            err = lib.denseconv_weight_grad(
                xb.data_ptr(), gyb.data_ptr(), part.data_ptr(), dw.data_ptr(), B, T, Ci, T_out,
                Co, K, dilation, padding[0], *plan.args,
                torch.cuda.current_stream(xb.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"denseconv dw kernel launch failed: cudaError {err}")
        self.launches_dw += 1
        return dw

    def __call__(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                 dilation: int = 1, padding: tuple[int, int] = (0, 0),
                 fold=None) -> torch.Tensor:
        """x [B, T, Ci], w [Co, Ci, K], b [Co] or None → [B, T_out, Co]; or
        with ``fold`` (``ops.conv``'s folds) K3 over ``fold.x(x)`` and
        ``fold.w(w)``, its result ``fold.y`` of the rows: the fold and its
        adjoints run inside the one autograd Function."""
        return _DenseConvFunction.apply(x, w, b, dilation, tuple(padding), self, fold)


class _DenseConvFunction(torch.autograd.Function):
    """K3 on a CUDA tensor, the plain version on a CPU one; the backward
    computes only the gradients asked for: K3 dx and K3 dw (or their plain
    versions), the bias's the fp32 sum of the incoming gradient. A fold
    rearranges the operands before, the result after, and the gradients
    back by its adjoints (``fold.gy``, ``fold.dx``, ``fold.dw``)."""

    @staticmethod
    def forward(ctx, x, w, b, dilation, padding, kernel, fold):
        ctx.conv = dict(dilation=dilation, padding=padding)
        ctx.kernel, ctx.fold = kernel, fold
        if fold is not None:
            x, w = fold.x(x), fold.w(w)
        ctx.x_shape = tuple(x.shape)
        if x.device.type == "cpu":
            ctx.save_for_backward(x, w)
            y = dense_conv1d_bf16_reference(x, w, b, **ctx.conv)
        else:
            xb = _bf16_operand(x, "x")
            ctx.save_for_backward(xb if ctx.needs_input_grad[1] else None, w)
            y = kernel.launch(xb, w, b, **ctx.conv)
        return y if fold is None else fold.y(y)

    @staticmethod
    def backward(ctx, gy):
        xs, w = ctx.saved_tensors
        want_dx, want_dw, want_db = ctx.needs_input_grad[:3]
        fold = ctx.fold
        if fold is not None:
            gy = fold.gy(gy)
        dx = dw = db = None
        if gy.device.type == "cpu":
            if want_dx:
                dx = dense_conv1d_bf16_input_grad_reference(gy, w, ctx.x_shape, **ctx.conv)
            if want_dw:
                dw = dense_conv1d_bf16_weight_grad_reference(xs, gy, w.shape, **ctx.conv)
        elif want_dx or want_dw:
            gyb = _bf16_operand(gy, "gy")
            if want_dx:
                dx = ctx.kernel.input_grad(gyb, w, ctx.x_shape, **ctx.conv)
            if want_dw:
                dw = ctx.kernel.weight_grad(xs, gyb, w.shape, **ctx.conv)
        if want_db:
            db = gy.sum((0, 1))
        if fold is not None:
            dx = None if dx is None else fold.dx(dx)
            dw = None if dw is None else fold.dw(dw)
        return dx, dw, db, None, None, None, None


denseconv = DenseConvKernel()
