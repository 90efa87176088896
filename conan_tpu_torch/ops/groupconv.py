"""Strided grouped 1-D convolution: kernel K2 and its plain version.

``groupconv`` is the counterpart of
``conan_tpu/ops/pallas_groupconv.py:pallas_grouped_conv1d``, the MSD's
grouped convs. On a CUDA tensor its forward launches the hand-written kernel
in ``csrc/groupconv.cu``, an implicit GEMM on the tensor cores at fp32
accuracy (the three-product tf32 split, whose weight half ``tf32_split``
makes here); its backward (dx and dw), the counterpart of the JAX
package's XLA VJP (``pallas_groupconv.py:151-158``), computes only the
gradients asked for. On a CPU tensor the forward runs the plain version,
``grouped_conv1d_reference``, and the backward plain torch
(``torch.nn.grad.conv1d_input`` / ``conv1d_weight``). There is no other
route: any other device raises. Layouts are the JAX package's: x [B, T, Ci]
channels-last, w [Co, Ci/groups, K], y [B, T_out, Co]. Dilation is 1: the
MSD, the only caller, dilates nothing.

The training rung (``ops/precision.py``) picks the route at call time. Under
"default" the forward is K2-bf16 (``groupconv_forward_bf16``): one bf16
product of bf16-rounded operands, fp32 accumulation, fp32 output, as the TPU
kernel computes when handed bf16 operands; its plain version is
``grouped_conv1d_reference`` on the rounded operands, in fp32; the backward
takes bf16-rounded operands too: on a CUDA tensor the hand-written K2-bf16
dx (the forward kernel run on one conv of gy whose out-channels are the
stride's phases side by side, ``bf16_dx_plan``, weights laid out as
``kernel_weights_bf16_dx``) and K2-bf16 dw
(``csrc/groupconv_bwd.cu``, ``bf16_wgrad_plan``; its (cig, cog) are the
MSD's, ``WGRAD_TPW``; one launch, split sums inside), both with fp32
results;
their plain versions ``grouped_conv1d_bf16_input_grad_reference`` and
``grouped_conv1d_bf16_weight_grad_reference`` are the CPU route. K2-bf16 is a
warp-specialized ``wgmma`` kernel fed by TMA whose M runs over 64-output
slots of the batch's rows; ``bf16_plan`` picks its tiles and sizes its
window buffers, and the one C call lays the weights out
(``kernel_weights_bf16`` is that layout's plain version), encodes the
tensor maps and launches. Under
"high" and "highest" (and outside training) the forward is the 3xTF32
kernel, more exact than "high" asks, and the backward cuDNN's fp32
``conv1d_input`` / ``conv1d_weight``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from conan_tpu_torch.ops import native
from conan_tpu_torch.ops.precision import bf16_dots


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


def kernel_weights_bf16(w: torch.Tensor) -> torch.Tensor:
    """w [Co, cig, K] as K2-bf16's TMA reads it, the plain version of the
    kernel's own preparation (``k2bf16_weights_kernel``): rounded to bf16
    (nearest even) in [Co, K·cigp], out-channel n's reduction r = j·cigp + ci
    contiguous, cigp = cig rounded up to 16 with zero channels (the wgmma's
    k is 16; the MSD's 128 → 256 layer has cig 8)."""
    Co, cig, K = w.shape
    cigp = -(-cig // 16) * 16
    wt = F.pad(w, (0, 0, 0, cigp - cig)).permute(0, 2, 1)                  # [Co, K, cigp]
    return wt.reshape(Co, K * cigp).to(torch.bfloat16).contiguous()


def phase_taps(K: int, stride: int, ph: int) -> int:
    """Taps j < K with j ≡ ph (mod stride): those of the input gradient's
    phase ph."""
    return -(-(K - ph) // stride)


def kernel_weights_bf16_dx(w: torch.Tensor, groups: int, stride: int) -> torch.Tensor:
    """w [Co, cig, K] as K2-bf16 dx's TMA reads it, the plain version of the
    kernel's own preparation (``k2bf16_dx_weights_kernel``):
    [stride · Ci, kp · cogp] bf16, kp = ceil(K / stride), cogp = cog rounded
    up to 16. Row (g · stride + ph) · cig + ci, the phases of a group side by
    side, holds phase ph's taps j = ph + stride · (kp - 1 - k) at k = kp -
    taps .. kp - 1 (flipped, and padded with zeros at the front, so that tap
    k of every phase reads the same gy row), each tap's cog out-channels of
    group g (the conv's channel roles swapped; zero past cog)."""
    Co, cig, K = w.shape
    cog, kp = Co // groups, -(-K // stride)
    cogp = _round_up(cog, 16)
    wg = w.reshape(groups, cog, cig, K).permute(0, 2, 3, 1)                # [G, cig, K, cog]
    wq = w.new_zeros(groups, stride, cig, kp, cogp)
    for ph in range(stride):
        taps = phase_taps(K, stride, ph)
        j = ph + stride * (taps - 1 - torch.arange(taps))
        wq[:, ph, :, kp - taps:, :cog] = wg[:, :, j]
    return wq.reshape(stride * groups * cig, kp * cogp).to(torch.bfloat16)


# K2-bf16's tiles by (wgmma width BN, cigp): (MI, NWG, KC, STAGES), the
# instantiations csrc/groupconv.cu:K2BF16_SHIPPED builds. A tile is MI·NWG
# m64 slots (64 outputs of one batch row each) by BN out-channels of one
# group; NWG consumer warpgroups, KC 64-wide weight boxes a stage, STAGES
# stages. BF16_DX_TILES: those K2BF16_DX_TILES builds with the input
# gradient's epilogue (the MSD's phases side by side: s·cig columns over
# cigp = cog rounded up to 16).
BF16_TILES = {(64, 64): (2, 1, 2, 3), (64, 32): (2, 1, 2, 3), (32, 32): (2, 1, 2, 4),
              (32, 16): (2, 1, 2, 4), (16, 16): (4, 1, 2, 3)}
BF16_DX_TILES = {(128, 64): (2, 1, 2, 3), (64, 64): (2, 1, 2, 3), (64, 32): (2, 1, 2, 3),
                 (32, 32): (2, 1, 2, 4), (16, 16): (4, 1, 2, 3)}
ROW_BOX = 16            # window rows a TMA box (csrc/groupconv.cu:kRowBox)
SLOT = 64               # outputs of one batch row an m64 block holds (kSlot)
SMEM_LIMIT = 227 * 1024


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class Bf16Plan(NamedTuple):
    """K2-bf16's tile plan for one geometry: ``args`` go to the C entry
    points; ``smem`` is the block's shared memory, ``n_tiles`` the tiles
    the persistent blocks walk."""
    bn: int
    mi: int
    nwg: int
    kc: int
    stages: int
    win_rows: int
    win_u: int
    smem: int
    n_tiles: int

    @property
    def args(self) -> tuple[int, ...]:
        return tuple(self)[:7]

    @property
    def mb(self) -> int:
        return self.mi * self.nwg


@functools.lru_cache(maxsize=512)
def bf16_plan(B: int, T_out: int, Ci: int, Co: int, groups: int, K: int, stride: int,
              tiles: tuple[int, ...] | None = None, dx: bool = False) -> Bf16Plan:
    """K2-bf16's plan: the widest wgmma width of 128, 64, 32, 16, 8 that
    divides cog and is built for cigp, with its tile (``BF16_TILES``; for the input
    gradient's conv, ``dx``, ``BF16_DX_TILES``), or ``tiles`` =
    (bn, mi, nwg, kc, stages). It sizes the fp32 staging buffer: a tile of
    MB = mi·nwg slots touches at most nseg = min(B, (MB-1) // slots + 2)
    batch rows (slots = ceil(T_out / 64) a row), and a segment of n outputs
    reads (n-1)·s + K rows, staged from a multiple of ROW_BOX; and the bf16
    window: its rows a phase, those over the stride and the 64 an m64 slot's
    descriptor reads past its first. Raises ValueError for what the kernel
    does not take."""
    cig, cog = Ci // groups, Co // groups
    if cig % 8 or cig > 64 or cog % 8:
        raise ValueError(f"groupconv_bf16: channels per group {cig} in (a multiple of 8, at "
                         f"most 64), {cog} out (a multiple of 8)")
    if stride not in (1, 2, 4, 8):
        raise ValueError(f"groupconv_bf16: stride {stride} (the window's phases: 1, 2, 4, 8)")
    if cig * K * 4 > 48 * 1024:
        raise ValueError(f"groupconv_bf16: an out-channel's {cig} x {K} weights past the "
                         f"layout kernel's 48 KB")
    cigp = _round_up(cig, 16)
    if tiles is None:
        table = BF16_DX_TILES if dx else BF16_TILES
        bn = next((n for n in (128, 64, 32, 16, 8) if cog % n == 0 and (n, cigp) in table),
                  None)
        if bn is None:
            raise ValueError(f"groupconv_bf16: no tile built for cog {cog}, cigp {cigp}")
        tiles = (bn, *table[bn, cigp])
    bn, mi, nwg, kc, stages = tiles
    mb, slots = mi * nwg, -(-T_out // SLOT)
    alloc_full = _round_up((T_out - 1) * stride + K, ROW_BOX)
    nseg = min(B, (mb - 1) // slots + 2)
    outs = min(mb * SLOT, nseg * T_out)
    win_rows = _round_up(min(nseg * alloc_full,
                             (outs - nseg) * stride + nseg * (K + ROW_BOX - 1)), ROW_BOX)
    win_u = win_rows // stride + SLOT
    smem = (1024 + stages * kc * bn * 128 + win_rows * cig * 4
            + (cigp // 8) * stride * win_u * 16 + 8 * (2 * stages + 2))
    if smem > SMEM_LIMIT:
        raise ValueError(f"groupconv_bf16: a window of {win_rows} rows needs {smem} bytes of "
                         f"shared memory")
    n_tiles = -(-B * slots // mb) * groups * (cog // bn)
    return Bf16Plan(bn, mi, nwg, kc, stages, win_rows, win_u, smem, n_tiles)


class DxGeometry(NamedTuple):
    """K2-bf16 dx's phases (``csrc/groupconv.cu:dx_geometry``): dx's padded
    row p = m · stride + ph, m = m0 + t (m0 = pad_l // stride), is column
    block ph of output t of one stride-1 conv of gy, each phase's flipped
    taps padded at the front to ``kp`` = ceil(K / stride); ``t_m`` outputs,
    the window ``pad`` rows to the left of t (the same for every phase),
    block ph of output t stored at dx row t · stride + ph - ``y_off`` where
    that lies in [0, T)."""
    kp: int
    t_m: int
    pad: int
    y_off: int


def dx_geometry(T: int, K: int, stride: int, pad_l: int) -> DxGeometry:
    m0, kp = pad_l // stride, -(-K // stride)
    return DxGeometry(kp, (T - 1 + pad_l) // stride - m0 + 1, kp - 1 - m0, pad_l - m0 * stride)


@functools.lru_cache(maxsize=512)
def bf16_dx_plan(B: int, T: int, Ci: int, T_out: int, Co: int, groups: int, K: int,
                 stride: int, pad_l: int) -> tuple[DxGeometry, Bf16Plan]:
    """K2-bf16 dx's phases and plan: the forward's plan (among
    ``BF16_DX_TILES``) of a stride-1 conv of gy, Co channels in and the
    phases side by side, stride · Ci out, kp taps, t_m outputs. Raises
    ValueError for what the kernel does not take."""
    if K < stride or pad_l < 0:
        raise ValueError(f"groupconv_bf16 dx: {K} taps at stride {stride} (every phase a tap), "
                         f"pad {pad_l}")
    geo = dx_geometry(T, K, stride, pad_l)
    if Ci % groups or (Ci // groups) % 8:
        raise ValueError(f"groupconv_bf16 dx: channels per group {Ci // groups} out (a "
                         f"multiple of 8)")
    return geo, bf16_plan(B, geo.t_m, Co, stride * Ci, groups, geo.kp, 1, dx=True)


WGRAD_ROWS = 64         # gy rows a chunk of K2-bf16 dw's reduction (groupconv_bwd.cu:kRc)
WGRAD_GY_LEAD = 16      # gy rows staged before a chunk's first, for the shifts (kGyLead)
WGRAD_MAX_STAGES = 4    # chunks in flight a block by TMA, fewer where shared memory is short
WGRAD_TILE_SLOTS = 3    # bf16 tile pairs a block (kTileSlots)
WGRAD_MAX_BOX_ROWS = 256   # rows a TMA box holds at most (kMaxBoxRows)
# K2-bf16 dw's instantiations, csrc/groupconv_bwd.cu:K2BF16_WGRAD_BUILT: the
# MSD's (cig, cog) and the B taps a consumer warpgroup multiplies (tpw x
# cig / 2 accumulators a thread, within the 240 registers the producer
# warpgroup hands each consumer thread: at 128-168 ptxas serialized or
# spilled the wgmmas of tpw 7-11 at cig 32, and at 240 tpw 11 at cig 32
# still spilled 4-16 bytes), at most WGRAD_MAX_WARPGROUPS
# consumer warpgroups a block (kMaxWarpgroups) beside the producer's
WGRAD_TPW = {(32, 32): 7, (8, 16): 6, (16, 32): 11, (32, 64): 7, (64, 64): 3}
WGRAD_CONSUMER_REGS = 240   # kConsumerRegs
WGRAD_MAX_WARPGROUPS = 2
WGRAD_WARPGROUPS = tuple(range(1, WGRAD_MAX_WARPGROUPS + 1))   # those the plan weighs
# the plan's reckoning of a chunk (groupconv_bwd.cu's design): a consumer's
# wgmma m64nNk16 reads 2 KB of A and N·32 bytes of B from shared memory at
# WGRAD_SMEM_BYTES_PER_CYCLE, TMA stages the chunk's fp32 x window and gy
# rows at WGRAD_LOAD_BYTES_PER_CYCLE, a consumer warpgroup rounds
# WGRAD_ROUND_PER_CYCLE values a cycle, and the three overlap, beside a
# fixed WGRAD_CHUNK_CYCLES; a split tile's partial sums are written and
# read back at the load rate
WGRAD_SMEM_BYTES_PER_CYCLE = 128
WGRAD_LOAD_BYTES_PER_CYCLE = 32
WGRAD_ROUND_PER_CYCLE = 32
WGRAD_CHUNK_CYCLES = 1000   # a chunk's waits and barrier (tools/torch_kernel_lab.py bwd)


class WgradPlan(NamedTuple):
    """K2-bf16 dw's plan: ``args`` go to the C entry point, which checks
    them against the geometry. M = 64 rows are ``shifts`` = 64 / cog shifts
    of gy's out-channels, so only the ``nbt`` B taps (``wgrad_b_taps``) are
    multiplied; a block takes ``nwg`` consumer warpgroups of ``tpw`` B taps
    (one of ``n_tb`` runs of a group's B taps; a tile is a group's run) and
    one of ``splits`` ranges of the reduction's ``n_chunks`` 64-row chunks
    (``wgrad_split``); ``stages`` chunks of ``stg_rows`` x rows are staged
    at once; a tile's dw order holds ``span`` taps; split tiles' partial
    sums take ``ws_floats`` of fp32 workspace (0 unsplit) and two int32
    counters a tile, ``n_tiles`` = groups · n_tb of them."""
    nwg: int
    tpw: int
    splits: int
    stages: int
    stg_rows: int
    nbt: int
    n_tb: int
    shifts: int
    n_chunks: int
    span: int
    n_tiles: int
    smem: int
    ws_floats: int

    @property
    def args(self) -> tuple[int, ...]:
        return tuple(self)[:5]


def wgrad_b_taps(K: int, stride: int, shifts: int) -> list[int]:
    """The taps K2-bf16 dw multiplies: j with j mod (shifts · stride) <
    stride, each giving taps j + d · stride, d < shifts, at once."""
    return [j for j in range(K) if j % (shifts * stride) < stride]


def wgrad_runs(K: int, stride: int, shifts: int, per: int) -> list[tuple[list[int], int, int]]:
    """The runs of ``per`` B taps (a tile's): each one's B taps, its first
    tap j_lo and its last j_hi (its B taps' shifts included)."""
    taps = wgrad_b_taps(K, stride, shifts)
    return [(taps[i:i + per], taps[i], min(K - 1, taps[min(i + per, len(taps)) - 1]
                                           + (shifts - 1) * stride))
            for i in range(0, len(taps), per)]


def wgrad_split(n_chunks: int, splits: int, sp: int) -> range:
    """The chunks c of split sp (chunk c: batch row c // cpr, outputs 64 ·
    (c % cpr) .. of it), as the kernel cuts them."""
    return range(sp * n_chunks // splits, (sp + 1) * n_chunks // splits)


def wgrad_share(rows: int, splits: int, sp: int) -> range:
    """The rows (o, ci) of a split tile's dw order that split sp adds up
    over the splits (in split order) and writes, as the kernel cuts them."""
    return range(sp * rows // splits, (sp + 1) * rows // splits)


@functools.lru_cache(maxsize=16)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def wgrad_smem(cig: int, cog: int, stride: int, stg_rows: int, stages: int, span: int) -> int:
    """K2-bf16 dw's shared memory (``groupconv_bwd.cu:wgrad_smem_bytes``):
    the staging and the tile slots, or the epilogue's dw-order tile where
    that is larger, beside the mbarriers."""
    win = cig // 8 * stride * (stg_rows // stride + 1) * 16
    main = (stages * (stg_rows * cig * 4 + (WGRAD_GY_LEAD + WGRAD_ROWS) * cog * 4)
            + WGRAD_TILE_SLOTS * (win + WGRAD_ROWS * 128))
    return 256 + max(main, cog * cig * span * 4)


def wgrad_stg_rows(rows: int) -> tuple[int, int]:
    """The staging rows for a window of ``rows`` x rows, and the TMA boxes
    that bring them: the fewest boxes of at most WGRAD_MAX_BOX_ROWS rows,
    each a multiple of ROW_BOX rows."""
    boxes = -(-rows // WGRAD_MAX_BOX_ROWS)
    return _round_up(rows, ROW_BOX * boxes), boxes


@functools.lru_cache(maxsize=512)
def bf16_wgrad_plan(B: int, T_out: int, Ci: int, Co: int, groups: int, K: int,
                    stride: int, sms: int) -> WgradPlan:
    """K2-bf16 dw's plan on a card of ``sms`` SMs: WGRAD_TPW's B taps a
    warpgroup, 1 to WGRAD_MAX_WARPGROUPS consumer warpgroups a block (the
    most of the cheapest by a reckoning of a chunk's products, loads and
    rounding, the WGRAD_*_PER_CYCLE rates, over the rounds of blocks the
    card runs, and of the split sums); splits only where the tiles fill less
    than half the card, then as many as keep a block an SM (the split
    launch is cooperative: its blocks are all resident), at most one a
    chunk. Raises ValueError for what the kernel does not take."""
    cig, cog = Ci // groups, Co // groups
    if (cig, cog) not in WGRAD_TPW:
        raise ValueError(f"groupconv_bf16 dw: channels per group {cig} in, {cog} out: built "
                         f"for (in, out) {tuple(WGRAD_TPW)}")
    if stride not in (1, 2, 4, 8):
        raise ValueError(f"groupconv_bf16 dw: stride {stride} (the window's phases: 1, 2, 4, 8)")
    shifts, tpw = 64 // cog, WGRAD_TPW[cig, cog]
    nbt = len(wgrad_b_taps(K, stride, shifts))
    n_chunks = B * -(-(T_out + shifts - 1) // WGRAD_ROWS)
    best, refused = None, ""
    for nwg in sorted((n for n in WGRAD_WARPGROUPS if n == 1 or n <= -(-nbt // tpw)),
                      reverse=True):
        runs = wgrad_runs(K, stride, shifts, nwg * tpw)
        window = max(bts[-1] - j_lo + 1 for bts, j_lo, _ in runs)
        span = max(j_hi - j_lo + 1 for _, j_lo, j_hi in runs)
        stg_rows, _boxes = wgrad_stg_rows((WGRAD_ROWS - 1) * stride + window)
        stages = next((n for n in range(WGRAD_MAX_STAGES, 1, -1)
                       if wgrad_smem(cig, cog, stride, stg_rows, n, span) <= SMEM_LIMIT), 0)
        if not stages or span > 64:   # the epilogue's lane takes two taps of a row
            refused = f"a window of {stg_rows} rows or a tile of {span} taps"
            continue
        tiles = groups * len(runs)
        splits = 1 if 2 * tiles > sms else min(n_chunks, sms // tiles)
        mma = 4 * nwg * tpw * (2048 + 32 * cig) / WGRAD_SMEM_BYTES_PER_CYCLE
        load = 4 * (stg_rows * cig + (WGRAD_GY_LEAD + WGRAD_ROWS) * cog) \
            / WGRAD_LOAD_BYTES_PER_CYCLE
        rnd = (stg_rows * cig + WGRAD_ROWS * 64) / WGRAD_ROUND_PER_CYCLE / nwg
        sums = 0 if splits == 1 else 8 * cog * cig * span / WGRAD_LOAD_BYTES_PER_CYCLE
        cost = -(-tiles * splits // sms) * (
            -(-n_chunks // splits) * (max(mma, load, rnd) + WGRAD_CHUNK_CYCLES) + sums)
        if best is None or cost < best[0]:
            smem = wgrad_smem(cig, cog, stride, stg_rows, stages, span)
            ws = 0 if splits == 1 else tiles * splits * cog * cig * span
            best = (cost, WgradPlan(nwg, tpw, splits, stages, stg_rows, nbt, len(runs), shifts,
                                    n_chunks, span, tiles, smem, ws))
    if best is None:
        raise ValueError(f"groupconv_bf16 dw: {refused} past the {SMEM_LIMIT} bytes of shared "
                         f"memory or 64 taps")
    return best[1]


def _rnd(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16, in its own type (``precision.rounded_dot``'s
    rounding of a dot's operands)."""
    return t.to(torch.bfloat16).to(t.dtype)


def grouped_conv1d_bf16_reference(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                                  padding: tuple[int, int] = (0, 0),
                                  groups: int) -> torch.Tensor:
    """K2-bf16's plain version: the fp32 grouped conv of the bf16-rounded
    operands."""
    rnd = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    return grouped_conv1d_reference(rnd(x), rnd(w), stride=stride, padding=padding,
                                    groups=groups)


def grouped_conv1d_bf16_input_grad_reference(gy: torch.Tensor, w: torch.Tensor, x_shape, *,
                                             stride: int = 1,
                                             padding: tuple[int, int] = (0, 0),
                                             groups: int) -> torch.Tensor:
    """K2-bf16 dx's plain version: ``conv1d_input`` in gy's type on
    the bf16-rounded w and gy [B, T_out, Co], channels-last like x; returns
    dx [B, T, Ci]."""
    B, T, Ci = x_shape
    pl, pr = padding
    dxp = torch.nn.grad.conv1d_input((B, Ci, T + pl + pr), _rnd(w), _rnd(gy).transpose(1, 2),
                                     stride=stride, groups=groups)
    return dxp[:, :, pl:pl + T].transpose(1, 2)


def grouped_conv1d_bf16_weight_grad_reference(x: torch.Tensor, gy: torch.Tensor, w_shape, *,
                                              stride: int = 1,
                                              padding: tuple[int, int] = (0, 0),
                                              groups: int) -> torch.Tensor:
    """K2-bf16 dw's plain version: ``conv1d_weight`` in x's type on
    the bf16-rounded x [B, T, Ci] and gy [B, T_out, Co]; returns dw [Co,
    Ci/groups, K]."""
    xp = F.pad(_rnd(x).transpose(1, 2), tuple(padding))
    return torch.nn.grad.conv1d_weight(xp, w_shape, _rnd(gy).transpose(1, 2), stride=stride,
                                       groups=groups)


class GroupConvKernel:
    """Wrapper of the CUDA kernels: checks its inputs, allocates the output,
    launches on the current stream and counts the launches of each kernel,
    ``launches`` (3xTF32: the weights split here, ``kernel_weights``),
    ``launches_bf16`` (K2-bf16: one allocation holds y and the weights'
    layout, which the one C call writes), ``launches_bf16_dx`` (its input
    gradient, likewise) and ``launches_bf16_dw`` (its weight gradient: one
    launch a call, its split sums inside)."""

    def __init__(self):
        self.launches = 0
        self.launches_bf16 = 0
        self.launches_bf16_dx = 0
        self.launches_bf16_dw = 0
        self._counters: dict[torch.device, torch.Tensor] = {}

    def _tile_counters(self, device: torch.device, n: int) -> torch.Tensor:
        """K2-bf16 dw's zeroed int32 counters, two a split tile: kept per
        device (the kernel leaves them zeroed), grown as a plan needs."""
        c = self._counters.get(device)
        if c is None or c.numel() < n:
            c = self._counters[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                                     device=device)
        return c

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
        lib = native.load()
        if x.data_ptr() % 16:      # the kernels read x in 16-byte chunks
            x = x.clone()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with _current(x.device):
            if bf16:
                plan = bf16_plan(B, T_out, Ci, Co, groups, K, stride)
                # y, then the weights' bf16 layout from a 128-byte boundary
                w_at = _round_up(B * T_out * Co, 32)
                buf = torch.empty(w_at + Co * K * _round_up(cig, 16) // 2, device=x.device)
                y = buf.as_strided((B, T_out, Co), (T_out * Co, Co, 1))
                err = lib.groupconv_forward_bf16(
                    x.data_ptr(), w.contiguous().data_ptr(), buf.data_ptr() + 4 * w_at,
                    y.data_ptr(), B, T, Ci, T_out, Co, groups, K, stride, padding[0],
                    *plan.args, stream)
            else:
                y = torch.empty(B, T_out, Co, device=x.device, dtype=torch.float32)
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

    def input_grad_bf16(self, gy: torch.Tensor, w: torch.Tensor, x_shape, *, stride: int,
                        padding: tuple[int, int], groups: int) -> torch.Tensor:
        """K2-bf16 dx: gy [B, T_out, Co] (fp32, CUDA) and w → dx [B, T, Ci]
        fp32 for x of ``x_shape``, from bf16-rounded w and gy."""
        B, T, Ci = x_shape
        Co, cig, K = w.shape
        _check_grad_operands("dx", gy, w, (B, None, Co))
        geo, plan = bf16_dx_plan(B, T, Ci, gy.shape[1], Co, groups, K, stride, padding[0])
        lib = native.load()
        gy = _aligned(gy)
        # dx, then the weights' phase layout from a 128-byte boundary
        wq_at = _round_up(B * T * Ci, 32)
        buf = torch.empty(wq_at + stride * Ci * geo.kp * _round_up(Co // groups, 16) // 2,
                          device=gy.device)
        dx = buf.as_strided((B, T, Ci), (T * Ci, Ci, 1))
        with _current(gy.device):
            err = lib.groupconv_input_grad_bf16(
                gy.data_ptr(), w.contiguous().data_ptr(), buf.data_ptr() + 4 * wq_at,
                dx.data_ptr(), B, T, Ci, gy.shape[1], Co, groups, K, stride, padding[0],
                *plan.args, torch.cuda.current_stream(gy.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"groupconv_bf16 dx kernel launch failed: cudaError {err}")
        self.launches_bf16_dx += 1
        return dx

    def weight_grad_bf16(self, x: torch.Tensor, gy: torch.Tensor, w_shape, *, stride: int,
                         padding: tuple[int, int], groups: int) -> torch.Tensor:
        """K2-bf16 dw: x [B, T, Ci] and gy [B, T_out, Co] (fp32, CUDA) → dw
        of ``w_shape`` [Co, Ci/groups, K] fp32, from bf16-rounded x and gy."""
        Co, cig, K = w_shape
        B, T, Ci = x.shape
        _check_grad_operands("dw", gy, x, (B, None, Co))
        plan = bf16_wgrad_plan(B, gy.shape[1], Ci, Co, groups, K, stride,
                               sm_count(x.device.index))
        lib = native.load()
        x, gy = _aligned(x), _aligned(gy)
        dw = torch.empty(Co, cig, K, device=x.device)
        ws = counters = None
        if plan.splits > 1:
            ws = torch.empty(plan.ws_floats, device=x.device)
            counters = self._tile_counters(x.device, 2 * plan.n_tiles)
        with _current(x.device):
            err = lib.groupconv_weight_grad_bf16(
                x.data_ptr(), gy.data_ptr(), None if ws is None else ws.data_ptr(),
                None if counters is None else counters.data_ptr(), dw.data_ptr(), B, T, Ci,
                gy.shape[1], Co, groups, K, stride, padding[0], *plan.args,
                torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"groupconv_bf16 dw kernel launch failed: cudaError {err}")
        self.launches_bf16_dw += 1
        return dw

    def __call__(self, x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 padding: tuple[int, int] = (0, 0), groups: int) -> torch.Tensor:
        """x [B, T, Ci], w [Co, Ci/groups, K] → [B, T_out, Co], no bias."""
        return _GroupConvFunction.apply(x, w, stride, tuple(padding), groups, self)


def _check_grad_operands(which: str, gy: torch.Tensor, other: torch.Tensor, shape) -> None:
    """Raises where the gradient kernels cannot take gy (a CUDA fp32 [B,
    T_out, Co] of ``shape``, None where any) beside ``other`` (w or x)."""
    if gy.device.type != "cuda" or other.device != gy.device:
        raise ValueError(f"groupconv_bf16 {which}: no kernel for gy on {gy.device}, "
                         f"{other.device}")
    if gy.dtype != torch.float32 or other.dtype != torch.float32:
        raise TypeError(f"groupconv_bf16 {which}: operands must be float32, got {gy.dtype}, "
                        f"{other.dtype}")
    if gy.dim() != 3 or any(n is not None and n != m for n, m in zip(shape, gy.shape)) \
            or gy.shape[1] < 1 or other.dim() != 3:
        raise ValueError(f"groupconv_bf16 {which}: gy {tuple(gy.shape)}, expected "
                         f"{shape} beside {tuple(other.shape)}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous from a 16-byte boundary, as the kernels' TMA reads it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _current(device: torch.device):
    """``torch.cuda.device(device)`` where it is not the current device
    already (entering it costs each of a step's 45 calls host time)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


class _GroupConvFunction(torch.autograd.Function):
    """Forward: K2 (3xTF32, or K2-bf16 under the "default" rung) on a CUDA
    tensor, the matching plain forward on a CPU one. Backward, only the
    gradients asked for: under "default" K2-bf16 dx and dw on a CUDA tensor,
    their plain versions on a CPU one; under the other rungs plain torch in
    fp32 (cuDNN on the card)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups, kernel):
        ctx.save_for_backward(x, w)
        ctx.conv = dict(stride=stride, groups=groups)
        ctx.padding = padding
        ctx.bf16 = bf16_dots()
        ctx.kernel = kernel
        if x.device.type == "cpu":
            ref = grouped_conv1d_bf16_reference if ctx.bf16 else grouped_conv1d_reference
            return ref(x, w, padding=padding, **ctx.conv)
        return kernel.launch(x, w, padding=padding, bf16=ctx.bf16, **ctx.conv)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        want_dx, want_dw = ctx.needs_input_grad[:2]
        dx = dw = None
        if ctx.bf16:
            on_card = x.device.type == "cuda"
            if want_dx:
                fn = ctx.kernel.input_grad_bf16 if on_card else \
                    grouped_conv1d_bf16_input_grad_reference
                dx = fn(gy, w, x.shape, padding=ctx.padding, **ctx.conv)
            if want_dw:
                fn = ctx.kernel.weight_grad_bf16 if on_card else \
                    grouped_conv1d_bf16_weight_grad_reference
                dw = fn(x, gy, w.shape, padding=ctx.padding, **ctx.conv)
            return dx, dw, None, None, None, None
        pl, pr = ctx.padding
        xp = F.pad(x.transpose(1, 2), (pl, pr))                     # [B, Ci, T + pl + pr]
        gy = gy.transpose(1, 2)                                     # [B, Co, T_out]
        if want_dx:
            dxp = torch.nn.grad.conv1d_input(xp.shape, w, gy, **ctx.conv)
            dx = dxp[:, :, pl:pl + x.shape[1]].transpose(1, 2)
        if want_dw:
            dw = torch.nn.grad.conv1d_weight(xp, w.shape, gy, **ctx.conv)
        return dx, dw, None, None, None, None


groupconv = GroupConvKernel()
