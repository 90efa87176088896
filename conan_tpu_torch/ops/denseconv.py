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
implicit GEMM on persistent blocks whose A is a window of x's rows staged
once a 64-channel chunk and indexed a tap at a time, the padding its zero
fill; dx is the same kernel over the flipped taps) and dw launches K3 dw
(``csrc/denseconv_bwd.cu``: both operands read in place as MN-major
``wgmma`` operands, a chunk staged once for every tap of the block, split
partial sums, where the plan splits, added in a fixed order in the same
launch). x and the incoming gradient are rounded to bf16 once a call here;
the one C call lays the weights out (``kernel_weights`` /
``kernel_weights_dx`` are that layout's plain versions), encodes the
tensor maps and launches. On a CPU
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
CHUNK = 64              # input channels a window (kChunk)
NWG = 2                 # K3's consumer warpgroups a block (kNwg)
MAX_WINDOW = 256        # window rows a TMA box holds (kMaxWindow)
SMEM_LIMIT = 227 * 1024
# K3's tiles (BN output channels, MI m64 slots a warpgroup) in the order the
# plan tries them, the instantiations csrc/denseconv.cu:DENSECONV_BUILT builds
DENSE_TILES = ((128, 2), (128, 1), (64, 2), (64, 1))
DENSE_WSTAGES = 4       # weight boxes in flight
DENSE_XSTAGES = 4       # window buffers in flight where a window serves fewer than 4 taps, else 2
WGRAD_ROWS = 64         # rows of dw's reduction a chunk (csrc/denseconv_bwd.cu:kRows)
# K3 dw's taps a warpgroup by out-channel tile NB, the instantiations
# csrc/denseconv_bwd.cu:DENSECONV_WGRAD_BUILT builds (TPW * NB / 2 accumulators)
WGRAD_TPW = {128: (1, 2), 64: (1, 2, 3, 4)}
WGRAD_CONSUMERS = 256   # two consumer warpgroups (kConsumers)
WGRAD_STAGES = 4        # chunks in flight, fewer where shared memory is short


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _rnd(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16, in its own type (``precision.rounded_dot``'s
    rounding of a dot's operands)."""
    return t.to(torch.bfloat16).to(t.dtype)


class DensePlan(NamedTuple):
    """K3's plan for one geometry: the tile (``bn`` output channels, ``mi``
    m64 slots a consumer warpgroup), ``tpr`` taps a window run of
    ``win_rows`` rows a slot, ``wstages`` weight boxes and ``xstages``
    windows in flight; ``args`` go to the C entry points; ``smem`` is a
    block's shared memory, ``tiles`` the tiles of the geometry it was
    planned for."""
    bn: int
    mi: int
    tpr: int
    win_rows: int
    wstages: int
    xstages: int
    smem: int
    tiles: int

    @property
    def args(self) -> tuple[int, ...]:
        return tuple(self)[:6]


def _check_channels(what: str, Ci: int, Co: int, K: int, dilation: int) -> None:
    if Ci < 8 or Ci % 8 or Co < 8 or Co % 8:
        raise ValueError(f"{what}: {Ci} channels in, {Co} out (each a multiple of 8, at least "
                         f"8: TMA's 16-byte row stride)")
    if K < 1 or dilation < 1:
        raise ValueError(f"{what}: {K} taps at dilation {dilation}")


def dense_smem(bn: int, mi: int, win_rows: int, xstages: int = 2,
               wstages: int = DENSE_WSTAGES) -> int:
    """A K3 block's shared memory (csrc/denseconv.cu:dense_smem_bytes): the
    weight ring, ``xstages`` window buffers of NWG * mi slots' windows, the
    barriers."""
    return 1024 + wstages * bn * 128 + xstages * NWG * mi * win_rows * 128 + \
        16 * (wstages + xstages)


def dense_window(K: int, dilation: int) -> tuple[int, int]:
    """(taps a run, window rows) of K3's windows: every tap in one window
    where its 64 + (K-1)·dilation rows fit a TMA box, else the fewest runs
    whose windows fit, their taps balanced (one tap a run at the least)."""
    for runs in range(1, K):
        tpr = -(-K // runs)
        rows = _round_up(SLOT + (tpr - 1) * dilation, 8)
        if rows <= MAX_WINDOW:
            return tpr, rows
    return 1, SLOT


@functools.lru_cache(maxsize=512)
def dense_plan(C: int, N: int, K: int, dilation: int = 1, slots: int = 1,
               sms: int = 1) -> DensePlan:
    """K3's plan for the conv of C input and N output channels, K taps at
    ``dilation``, over ``slots`` m64 slots of output rows (the input
    gradient's: C the forward's Co, N its Ci) on a card of ``sms`` SMs: the
    window of dense_window; the first tile of DENSE_TILES (an output tile
    width of 64 only where 128 wastes more columns of N) whose shared
    memory fits and whose tiles reach half the SMs, else the one with the
    most tiles (the larger tiles reuse each weight box more, the smaller
    keep more SMs at work on a short conv: `tools/torch_denseconv_lab.py
    sweep`); DENSE_XSTAGES windows in flight where a window serves fewer
    than 4 taps and they fit, else 2. Raises ValueError for what the kernel
    does not take."""
    _check_channels("denseconv", C, N, K, dilation)
    tpr, rows = dense_window(K, dilation)
    widths = (128, 64) if _round_up(N, 128) <= _round_up(N, 64) else (64,)
    fits = []
    for bn, mi in DENSE_TILES:
        xstages = DENSE_XSTAGES if tpr < 4 else 2
        while xstages > 2 and dense_smem(bn, mi, rows, xstages) > SMEM_LIMIT:
            xstages -= 1
        smem = dense_smem(bn, mi, rows, xstages)
        if bn not in widths or smem > SMEM_LIMIT:
            continue
        tiles = -(-slots // (NWG * mi)) * -(-N // bn)
        plan = DensePlan(bn, mi, tpr, rows, DENSE_WSTAGES, xstages, smem, tiles)
        if 2 * tiles >= sms:
            return plan
        fits.append(plan)
    return max(fits, key=lambda p: p.tiles)   # (64, 1) fits any window


class WgradTiles(NamedTuple):
    """K3 dw's tiling of one geometry: ``nb`` out-channels a block, ``tpw``
    taps a consumer warpgroup, ``xboxes`` 64-channel x boxes a block (2: the
    warpgroups take 64 in-channels each at the same taps; 1: the same 64
    in-channels at tpw taps each), ``taps`` a block, ``runs`` runs of taps,
    ``win_rows`` x rows a chunk's window, ``stages`` chunks in flight,
    ``smem`` a block's shared memory."""
    nb: int
    tpw: int
    xboxes: int
    taps: int
    runs: int
    win_rows: int
    stages: int
    smem: int


def wgrad_smem(nb: int, xboxes: int, win_rows: int, stages: int) -> int:
    """A K3 dw block's shared memory (csrc/denseconv_bwd.cu:wgrad_smem_bytes)."""
    return 1024 + stages * (nb // 64 * WGRAD_ROWS * 128 + xboxes * win_rows * 128 + 16)


# the plan's reckoning of a tile's time on one SM, in cycles: a chunk takes
# the longer of its products at the dense bf16 rate (4096 FLOP a cycle) over
# the share of it a tile width reaches with both operands in shared memory
# and its staged bytes at WGRAD_STAGE_BYTES_PER_CYCLE; the tile's dw stores
# one a cycle (a thread's taps of one weight in one store where they align)
WGRAD_MMA_SHARE = {128: 0.8, 64: 0.65}
WGRAD_STAGE_BYTES_PER_CYCLE = 48


@functools.lru_cache(maxsize=512)
def dense_wgrad_tiles(Ci: int, Co: int, K: int, dilation: int,
                      n_chunks: int = 1024) -> WgradTiles:
    """K3 dw's tiles for a reduction of ``n_chunks`` 64-row chunks: of the
    built (out-channels a block, taps a warpgroup) and the two ways of
    sharing the block's x window, whose window fits a TMA box and whose two
    stages fit shared memory, the one whose tiles take the fewest cycles in
    all (WGRAD_MMA_SHARE, WGRAD_STAGE_BYTES_PER_CYCLE: the products, taps
    past K and channels past Ci and Co included, against the bytes staged,
    and the stores), then the fewest bytes staged. Raises ValueError for
    what the kernel does not take."""
    _check_channels("denseconv dw", Ci, Co, K, dilation)
    best = None
    for nb, xboxes in ((128, 2), (128, 1), (64, 2), (64, 1)):
        for tpw in WGRAD_TPW[nb]:
            taps = tpw * (3 - xboxes)
            if taps > 2 * K:
                continue
            win = _round_up(WGRAD_ROWS + (taps - 1) * dilation, 8)
            stage = nb // 64 * WGRAD_ROWS * 128 + xboxes * win * 128
            stages = min(WGRAD_STAGES, (SMEM_LIMIT - 1024) // (stage + 16))
            if win > MAX_WINDOW or stages < 2:
                continue
            tiles = -(-K // taps) * -(-Ci // (64 * xboxes)) * -(-Co // nb)
            mma = 2 * WGRAD_ROWS * taps * 64 * xboxes * nb / 4096 / WGRAD_MMA_SHARE[nb]
            vec = tpw if tpw in (2, 4) and K % tpw == 0 else 1
            cycles = n_chunks * max(mma, stage / WGRAD_STAGE_BYTES_PER_CYCLE) + \
                64 * xboxes * nb * taps / vec
            key = (tiles * cycles, tiles * stage)
            if best is None or key < best[0]:
                best = (key, WgradTiles(nb, tpw, xboxes, taps, -(-K // taps), win, stages,
                                        wgrad_smem(nb, xboxes, win, stages)))
    return best[1]   # one tap on two boxes fits any dilation


class WgradPlan(NamedTuple):
    """K3 dw's plan: its tiles, ``n_tiles`` of them, each in ``splits``
    ranges of the reduction's ``n_chunks`` 64-row chunks; ``args`` go to
    the C entry point, which checks them; split tiles' partial sums take
    ``ws_floats`` of fp32 workspace (0 unsplit) and two int32 counters a
    tile."""
    tiles: WgradTiles
    n_tiles: int
    splits: int
    n_chunks: int
    ws_floats: int

    @property
    def args(self) -> tuple[int, ...]:
        t = self.tiles
        return (t.nb, t.tpw, t.xboxes, t.stages, t.win_rows, self.splits)


@functools.lru_cache(maxsize=512)
def dense_wgrad_plan(B: int, T_out: int, Ci: int, Co: int, K: int, dilation: int,
                     sms: int) -> WgradPlan:
    """K3 dw's plan on a card of ``sms`` SMs: ``dense_wgrad_tiles``; splits
    only where the tiles fill less than half the card, then as many as keep
    a block an SM (the split launch is cooperative: its blocks are all
    resident), at most one a chunk."""
    n_chunks = B * -(-T_out // WGRAD_ROWS)
    t = dense_wgrad_tiles(Ci, Co, K, dilation, n_chunks)
    n_tiles = -(-Ci // (64 * t.xboxes)) * -(-Co // t.nb) * t.runs
    splits = 1 if 2 * n_tiles > sms else min(n_chunks, sms // n_tiles)
    ws = 0 if splits == 1 else n_tiles * splits * t.tpw * t.nb // 2 * WGRAD_CONSUMERS
    return WgradPlan(t, n_tiles, splits, n_chunks, ws)


def dense_kernel_takes(Ci: int, Co: int, K: int, dilation: int) -> bool:
    """Whether K3, its dx and its dw take a dense stride-1 conv of Ci
    input and Co output channels, K taps at ``dilation``: the route's one
    decision, from the shape alone (``ops.conv.conv1d``)."""
    try:
        dense_plan(Ci, Co, K, dilation)
        dense_plan(Co, Ci, K, dilation)
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
    and ``launches_dw`` (K3 dw: one launch a call, its split sums inside)."""

    def __init__(self):
        self.launches = 0
        self.launches_dx = 0
        self.launches_dw = 0
        self._counters: dict[torch.device, torch.Tensor] = {}

    def _tile_counters(self, device: torch.device, n: int) -> torch.Tensor:
        """K3 dw's zeroed int32 counters, two a split tile: kept per device
        (the kernel leaves them zeroed), grown as a plan needs."""
        c = self._counters.get(device)
        if c is None or c.numel() < n:
            c = self._counters[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                                     device=device)
        return c

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
        plan = dense_plan(C, N, K, dilation, B * -(-T_out // SLOT), sm_count(xb.device.index))
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
        ws = counters = None
        if plan.splits > 1:
            ws = torch.empty(plan.ws_floats, device=xb.device)
            counters = self._tile_counters(xb.device, 2 * plan.n_tiles)
        with _current(xb.device):
            err = lib.denseconv_weight_grad(
                xb.data_ptr(), gyb.data_ptr(), None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(), dw.data_ptr(), B, T, Ci,
                T_out, Co, K, dilation, padding[0], *plan.args,
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
