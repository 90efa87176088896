"""K2-bf16's tile plan (``conan_tpu_torch/ops/groupconv.py:bf16_plan``), on
the CPU.

The kernel (``csrc/groupconv.cu:groupconv_bf16_kernel``) folds the batch into
M: M tile mt holds the m64 slots v = mt·MB .. (slot v: batch row v // slots,
outputs 64·(v % slots) .., slots = ceil(T_out / 64)), and its window is
staged as one segment per batch row it touches, each from a multiple of
ROW_BOX rows, then laid out as [8-channel chunk][row % s][row // s] for the
wgmma's descriptors, each slot reading 64 rows from its first. ``_tile`` and
``_window_row`` below repeat the kernel's arithmetic (``tile_rows``,
``window_row`` and the producer's segment loop). The tests check, on the
MSD's 15 grouped geometries at the training batch and on ragged ones, that
every output (b, t) falls in exactly one tile, that each segment's boxes
land inside the plan's staging buffer, that every output's K taps read its
own input rows and every slot's descriptor reads stay inside the window;
and they run the conv through that staging in float64 against the bf16
plain version.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from conan_tpu_torch.models.vocoder.discriminators import DiscriminatorS
from conan_tpu_torch.ops.groupconv import (BF16_TILES, ROW_BOX, SLOT, SMEM_LIMIT, bf16_plan,
                                           grouped_conv1d_bf16_reference)
from tests.torch_port_util import one_torch_thread  # noqa: F401

TRAIN_B, TRAIN_T = 18, 8000      # chip_smoke.py's vocoder batch


def _msd_geometries(T: int) -> list[tuple]:
    """(input length, ci, co, k, stride, groups, pad) of the MSD's grouped
    convs on T samples, at T, T/2 and T/4 (chip_smoke.py's order)."""
    geoms, t_scale = [], T
    for scale in range(3):
        if scale:
            t_scale = (t_scale + 2 - 4) // 2 + 1     # AvgPool1d(4, 2, padding=1)
        t = t_scale
        for ci, co, k, s, g, pd in DiscriminatorS.LAYERS:
            if g > 1:
                geoms.append((t, ci, co, k, s, g, pd))
            t = (t + 2 * pd - k) // s + 1
    return geoms


def _ru(v: int, m: int) -> int:
    return -(-v // m) * m


def _tile(plan, B, T_out, K, s, pad_l, mt):
    """M tile mt as the kernel stages it: (slot range, segments), a segment
    (b, t_lo, t_hi, staged base row, first input row, window rows)."""
    slots = -(-T_out // SLOT)
    v0 = mt * plan.mb
    v1 = min(v0 + plan.mb, B * slots)
    b_first, b_last = v0 // slots, (v1 - 1) // slots
    alloc_full = _ru((T_out - 1) * s + K, ROW_BOX)
    segs, row = [], 0
    for b in range(b_first, b_last + 1):
        t_lo = (v0 - b_first * slots) * SLOT if b == b_first else 0
        t_hi = min((v1 - b * slots) * SLOT, T_out) - 1 if b == b_last else T_out - 1
        n = (t_hi - t_lo) * s + K
        segs.append((b, t_lo, t_hi, row, t_lo * s - pad_l, n))
        row += _ru(n, ROW_BOX) if b == b_first else alloc_full
    return (v0, v1), segs


def _window_row(T_out, K, s, v0, v1, b, t):
    """csrc/groupconv.cu:window_row: the staging row of output t of batch
    row b in the tile of slots v0 .. v1-1."""
    slots = -(-T_out // SLOT)
    b_first, b_last = v0 // slots, (v1 - 1) // slots
    t_lo_first = (v0 - b_first * slots) * SLOT
    t_hi = min((v1 - b_first * slots) * SLOT, T_out) - 1 if b_first == b_last else T_out - 1
    alloc_first = _ru((t_hi - t_lo_first) * s + K, ROW_BOX)
    alloc_full = _ru((T_out - 1) * s + K, ROW_BOX)
    if b == b_first:
        return (t - t_lo_first) * s
    return alloc_first + (b - b_first - 1) * alloc_full + t * s


def _check_plan(B, T, ci, co, k, s, g, pd, tiles=None):
    T_out = (T + 2 * pd - k) // s + 1
    plan = bf16_plan(B, T_out, ci, co, g, k, s, tiles)
    slots = -(-T_out // SLOT)
    assert plan.smem <= SMEM_LIMIT
    assert plan.n_tiles == -(-B * slots // plan.mb) * g * (co // g // plan.bn)
    covered = np.zeros((B, T_out), np.int64)
    for mt in range(-(-B * slots // plan.mb)):
        (v0, v1), segs = _tile(plan, B, T_out, k, s, pd, mt)
        b, t_lo, t_hi, base, in0, n = segs[-1]
        assert base + _ru(n, ROW_BOX) <= plan.win_rows, (mt, segs)   # the boxes fit
        for v in range(v0, v1):
            b, t0 = divmod(v, slots)
            t0 *= SLOT
            first = _window_row(T_out, k, s, v0, v1, b, t0)
            assert first % s == 0
            # the slot's descriptors read window rows first/s + j//s .. + 63 of a phase,
            # j < k: those its segment staged and the rows up to 63 past them
            assert first // s + SLOT - 1 + (k - 1) // s < plan.win_u + (k - 1) // s
            seg_end = (segs[-1][3] + segs[-1][5] - 1) // s
            assert first // s + SLOT - 1 + (k - 1) // s <= seg_end + SLOT - 1 < plan.win_u
            seg = next(sg for sg in segs if sg[0] == b)
            for t in range(t0, min(t0 + SLOT, T_out)):
                covered[b, t] += 1
                row = first + (t - t0) * s
                assert row == _window_row(T_out, k, s, v0, v1, b, t)
                # its K taps read its own input rows t·s - pad_l + j, inside its segment
                assert row - seg[3] + seg[4] == t * s - pd
                assert 0 <= row - seg[3] and row - seg[3] + k <= seg[5]
    np.testing.assert_array_equal(covered, 1)
    return plan


@pytest.mark.parametrize("index", range(15))
@pytest.mark.parametrize("B", [TRAIN_B, 1, 3])
def test_bf16_plan_covers_every_msd_output_once(index, B):
    """The shipped plan on each MSD geometry (B = 18 as trained; 1 and 3)."""
    T, ci, co, k, s, g, pd = _msd_geometries(TRAIN_T)[index]
    plan = _check_plan(B, T, ci, co, k, s, g, pd)
    assert (plan.bn, -(-ci // g // 16) * 16) in BF16_TILES


RAGGED = [
    # B, T, ci, co, k, s, g, pad: T_out 7 (< 16), 121 and 249 (no multiple of 64), 1,
    # the cig 8 layer, stride 8
    (3, 13, 128, 128, 41, 2, 4, 20),
    (5, 121, 1024, 1024, 41, 1, 16, 20),
    (2, 993, 256, 512, 41, 4, 16, 20),
    (7, 1, 512, 1024, 41, 4, 16, 20),
    (4, 497, 128, 256, 41, 2, 16, 20),
    (1, 40, 64, 64, 5, 8, 4, 1),
]


@pytest.mark.parametrize("case", RAGGED)
@pytest.mark.parametrize("tiles", [None, (16, 1, 1, 2, 4), (16, 2, 1, 1, 3)])
def test_bf16_plan_covers_ragged_outputs_once(case, tiles):
    """Ragged batches and lengths, under the shipped tiles and at 1 and 2
    slots a tile."""
    B, T, ci, co, k, s, g, pd = case
    _check_plan(B, T, ci, co, k, s, g, pd, tiles)


@pytest.mark.parametrize("case", [c for c in RAGGED if c[2] // c[6] <= 16])
def test_bf16_plan_covers_ragged_outputs_once_at_four_slots(case):
    """Four slots a tile, where the narrow layers' windows fit."""
    B, T, ci, co, k, s, g, pd = case
    _check_plan(B, T, ci, co, k, s, g, pd, (16, 4, 1, 1, 3))


@pytest.mark.parametrize("case", RAGGED[:4] + [(18, 32, 1024, 1024, 41, 1, 16, 20)])
def test_bf16_staged_conv_equals_the_plain_version(case):
    """The conv computed as the kernel stages it, in float64: each tile's
    segments filled box by box from the bf16-rounded x (zero outside [0, T)),
    each output summing its K window rows against the rounded weights, held
    to the bf16 plain version at fp32's sum-order error."""
    B, T, ci, co, k, s, g, pd = case
    rng = np.random.default_rng(B * T + ci)
    x = torch.from_numpy(rng.standard_normal((B, T, ci)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((co, ci // g, k)) / np.sqrt(k * ci / g))
                         .astype(np.float32))
    T_out = (T + 2 * pd - k) // s + 1
    plan = bf16_plan(B, T_out, ci, co, g, k, s)
    xr = x.to(torch.bfloat16).double().numpy()
    wr = w.to(torch.bfloat16).double().numpy()                     # [co, cig, k]
    cig, cog = ci // g, co // g
    y = np.zeros((B * T_out, co))
    slots = -(-T_out // SLOT)
    for mt in range(-(-B * slots // plan.mb)):
        (v0, v1), segs = _tile(plan, B, T_out, k, s, pd, mt)
        staged = np.full((plan.win_rows, ci), np.nan)
        for b, t_lo, t_hi, base, in0, n in segs:
            for box in range(0, n, ROW_BOX):
                for r in range(ROW_BOX):
                    tin = in0 + box + r
                    staged[base + box + r] = xr[b, tin] if 0 <= tin < T else 0.0
        # the bf16 window as [phase][row // s] (the chunk of channels aside)
        window = np.full((s, plan.win_u, ci), np.nan)     # one of the two
        for q in range(plan.win_rows):
            window[q % s, q // s] = staged[q]
        for v in range(v0, v1):
            b, t0 = divmod(v, slots)
            t0 *= SLOT
            u0 = _window_row(T_out, k, s, v0, v1, b, t0) // s
            for t in range(t0, min(t0 + SLOT, T_out)):
                win = np.stack([window[j % s, u0 + t - t0 + j // s] for j in range(k)])
                for gg in range(g):
                    y[b * T_out + t, gg * cog:(gg + 1) * cog] = np.einsum(
                        "jc,ocj->o", win[:, gg * cig:(gg + 1) * cig],
                        wr[gg * cog:(gg + 1) * cog])
    want = grouped_conv1d_bf16_reference(x, w, stride=s, padding=(pd, pd), groups=g)
    torch.testing.assert_close(torch.from_numpy(y).float().reshape(B, T_out, co), want,
                               rtol=1e-5, atol=1e-5)


def test_bf16_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="channels per group"):
        bf16_plan(2, 100, 1024, 1024, 8, 41, 1)                    # cig 128
    with pytest.raises(ValueError, match="stride 3"):
        bf16_plan(2, 100, 256, 256, 16, 41, 3)
    with pytest.raises(ValueError, match="48 KB"):
        bf16_plan(2, 100, 1024, 1024, 16, 193, 1)                  # 64 x 193 weights
    with pytest.raises(ValueError, match="channels per group"):
        bf16_plan(2, 100, 128, 72, 4, 41, 1)                       # cog 18
    with pytest.raises(ValueError, match="shared memory"):
        bf16_plan(2, 4000, 64, 128, 4, 760, 4)                     # a window past 227 KB


def test_bf16_plan_tiles_are_what_the_kernel_builds():
    """The plan's tiles (BF16_TILES, by (BN, cigp): (MI, NWG, KC, STAGES))
    are csrc/groupconv.cu's shipped instantiations, and its slot and box
    rows the kernel's (a mismatch shows only on the card, as a refused
    launch)."""
    csrc = Path(__file__).resolve().parents[1] / "conan_tpu_torch" / "csrc"
    src = (csrc / "groupconv.cu").read_text()
    shipped = re.search(r"#define K2BF16_SHIPPED\(X\)(.*?)\n\n", src, re.S).group(1)
    tiles = [tuple(int(v) for v in t) for t in
             re.findall(r"X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)", shipped)]
    assert {t[:2]: t[2:] for t in tiles} == BF16_TILES and len(tiles) == len(BF16_TILES)
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src + (csrc / "k2bf16.cuh").read_text())}
    assert (consts["kSlot"], consts["kRowBox"]) == (SLOT, ROW_BOX)
