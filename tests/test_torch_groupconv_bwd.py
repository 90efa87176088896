"""K2-bf16's backward on the CPU: the plain versions of its two kernels
(``conan_tpu_torch/ops/groupconv.py``: ``grouped_conv1d_bf16_input_grad_reference``
and ``grouped_conv1d_bf16_weight_grad_reference``) against the JAX package's
VJP, and what surrounds the CUDA kernels (``csrc/groupconv.cu``: K2-bf16 dx,
the forward kernel over the stride's phases; ``csrc/groupconv_bwd.cu``:
K2-bf16 dw), repeated here in Python: dx's per-phase weight layout and
phase geometry, dw's split of the reduction into 64-row chunks, its staged
windows, its runs of B taps and gy's shifts in M, and the plans' refusals.

The plain versions are held to ``jax.vjp`` of
``conan_tpu.ops.grouped_conv.grouped_conv1d_blocked`` (the VJP the JAX
package's Pallas forward takes, ``pallas_groupconv.py:151-158``) on
bf16-rounded x, w and gy in fp32: JAX's DEFAULT with an fp32 result. The
tolerance is tests/test_torch_groupconv.py's for gradients, atol 5e-4 /
rtol 1e-3: fp32 sums of the same exact products in other orders.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conan_tpu.ops.grouped_conv import grouped_conv1d_blocked

from conan_tpu_torch.ops.groupconv import (BF16_DX_TILES, ROW_BOX, SMEM_LIMIT, WGRAD_GY_LEAD,
                                           WGRAD_CONSUMER_REGS, WGRAD_MAX_BOX_ROWS,
                                           WGRAD_MAX_STAGES,
                                           WGRAD_MAX_WARPGROUPS, WGRAD_ROWS, WGRAD_TILE_SLOTS,
                                           WGRAD_TPW, bf16_dx_plan,
                                           bf16_wgrad_plan, dx_geometry,
                                           grouped_conv1d_bf16_input_grad_reference,
                                           grouped_conv1d_bf16_weight_grad_reference,
                                           grouped_conv1d_reference, kernel_weights_bf16_dx,
                                           phase_taps, wgrad_runs, wgrad_share, wgrad_smem,
                                           wgrad_split)
from tests.test_pallas_groupconv import MSD_LAYERS
from tests.test_torch_groupconv_bf16_plan import TRAIN_B, TRAIN_T, _msd_geometries
from tests.torch_port_util import one_torch_thread  # noqa: F401

GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3
H100_SMS = 132                   # the card dw's plan was tuned on
CSRC = Path(__file__).resolve().parents[1] / "conan_tpu_torch" / "csrc"


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _conv_inputs(B, T, ci, co, k, s, g, pd, seed):
    """Seeded x, w and gy (for the output of T samples), rounded to bf16."""
    rng = np.random.default_rng(seed)
    T_out = (T + 2 * pd - k) // s + 1
    x = _bf16(rng.standard_normal((B, T, ci)).astype(np.float32))
    w = _bf16((rng.standard_normal((co, ci // g, k)) * 0.1).astype(np.float32))
    gy = _bf16(rng.standard_normal((B, T_out, co)).astype(np.float32))
    return x, w, gy


# the MSD's five grouped layers at small B, each at two lengths: T_out 60 or
# 25 (as tests/test_torch_groupconv.py) and a ragged one
GRAD_CASES = [(2, T, ci, co, k, s, g) for ci, co, k, s, g in MSD_LAYERS
              for T in ((120 if ci <= 256 else 50), 37 + s)]


@pytest.mark.parametrize("B,T,ci,co,k,s,g", GRAD_CASES)
def test_bf16_grad_references_match_jax_vjp(B, T, ci, co, k, s, g):
    pd = (k - 1) // 2
    x, w, gy = _conv_inputs(B, T, ci, co, k, s, g, pd, seed=T + ci + co)
    _, vjp = jax.vjp(lambda xx, ww: grouped_conv1d_blocked(
        xx, ww, stride=s, padding=(pd, pd), groups=g), x, w)
    want_dx, want_dw = (np.asarray(a) for a in vjp(gy))
    conv = dict(stride=s, padding=(pd, pd), groups=g)
    got_dx = grouped_conv1d_bf16_input_grad_reference(torch.from_numpy(gy),
                                                      torch.from_numpy(w), x.shape, **conv)
    got_dw = grouped_conv1d_bf16_weight_grad_reference(torch.from_numpy(x),
                                                       torch.from_numpy(gy), w.shape, **conv)
    assert got_dx.dtype == got_dw.dtype == torch.float32
    assert want_dx.dtype == want_dw.dtype == np.float32
    np.testing.assert_allclose(got_dx.numpy(), want_dx, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    np.testing.assert_allclose(got_dw.numpy(), want_dw, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_bf16_grad_references_round_their_operands():
    """Unrounded operands give the gradients of their bf16 roundings."""
    B, T, ci, co, k, s, g = GRAD_CASES[2]
    pd = (k - 1) // 2
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((B, T, ci)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((co, ci // g, k)) * 0.1).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((B, (T + 2 * pd - k) // s + 1, co))
                          .astype(np.float32))
    r = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    conv = dict(stride=s, padding=(pd, pd), groups=g)
    torch.testing.assert_close(grouped_conv1d_bf16_input_grad_reference(gy, w, x.shape, **conv),
                               grouped_conv1d_bf16_input_grad_reference(r(gy), r(w), x.shape,
                                                                        **conv), rtol=0, atol=0)
    torch.testing.assert_close(grouped_conv1d_bf16_weight_grad_reference(x, gy, w.shape, **conv),
                               grouped_conv1d_bf16_weight_grad_reference(r(x), r(gy), w.shape,
                                                                         **conv), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K2-bf16 dx: the stride's phases, each a stride-1 conv of gy
# ---------------------------------------------------------------------------

# (B, T, ci, co, k, s, g, pad): the MSD's layers, T_out 1, pads that no
# stride divides (y_off > 0), K = s, a stride of 8
DX_CASES = ([(2, 37 + s, ci, co, k, s, g, (k - 1) // 2) for ci, co, k, s, g in MSD_LAYERS]
            + [(1, 3, 512, 1024, 41, 4, 16, 20), (2, 29, 64, 128, 7, 2, 4, 3),
               (3, 31, 64, 64, 9, 4, 4, 6), (1, 12, 32, 64, 4, 4, 4, 1),
               (2, 45, 64, 64, 21, 8, 4, 10)])


def _dx_by_phases(gy, w, T, s, g, pd):
    """dx as K2-bf16 dx computes it, in float64: one stride-1 grouped conv of
    gy whose s·cig out-channels a group are the phases side by side (the
    kernel's weight layout, kernel_weights_bf16_dx: each phase's taps
    flipped and padded at the front to kp), its window pad rows to the left
    of t for every phase, column block ph of output t stored at dx row t·s +
    ph - y_off. Returns dx and how often each row was written."""
    B, T_out, Co = gy.shape
    _, cig, K = w.shape
    Ci, cog = g * cig, Co // g
    geo = dx_geometry(T, K, s, pd)
    cogp = -(-cog // 16) * 16
    wq = kernel_weights_bf16_dx(w, g, s).double().reshape(s * Ci, geo.kp, cogp)
    w_all = wq[:, :, :cog].permute(0, 2, 1)                        # [s·Ci, cog, kp]
    # outputs t = 0 .. t_m - 1 read gy rows t - pad .. t - pad + kp - 1
    right = max(0, geo.t_m - 1 - geo.pad + geo.kp - T_out)
    y = grouped_conv1d_reference(gy.double()[:, max(0, -geo.pad):], w_all, stride=1,
                                 padding=(max(0, geo.pad), right), groups=g)[:, :geo.t_m]
    y = y.reshape(B, geo.t_m, g, s, cig)
    dx = torch.zeros(B, T, Ci, dtype=torch.float64)
    written = torch.zeros(T, dtype=torch.int64)
    for ph in range(s):
        rows = torch.arange(geo.t_m) * s + ph - geo.y_off
        keep = (rows >= 0) & (rows < T)
        dx[:, rows[keep]] = y[:, keep, :, ph].reshape(B, -1, Ci)
        written[rows[keep]] += 1
    return dx, written


@pytest.mark.parametrize("case", DX_CASES)
def test_dx_phase_layout_recombines_to_conv1d_input(case):
    """Integer-valued w and gy (exact in bf16 and in every float64 sum): the
    phases side by side over the kernel's weight layout equal conv1d_input
    bit for bit, and every dx row is written once."""
    B, T, ci, co, k, s, g, pd = case
    rng = np.random.default_rng(sum(case))
    T_out = (T + 2 * pd - k) // s + 1
    w = torch.from_numpy(rng.integers(-8, 9, (co, ci // g, k)).astype(np.float32))
    gy = torch.from_numpy(rng.integers(-8, 9, (B, T_out, co)).astype(np.float32))
    got, written = _dx_by_phases(gy, w, T, s, g, pd)
    want = grouped_conv1d_bf16_input_grad_reference(gy.double(), w.double(), (B, T, ci),
                                                    stride=s, padding=(pd, pd), groups=g)
    assert torch.equal(got, want)
    assert torch.equal(written, torch.ones(T, dtype=torch.int64))


@pytest.mark.parametrize("case", DX_CASES)
def test_dx_front_padded_phases_read_the_same_gy_rows(case):
    """Where the layout puts tap j of phase ph (its k-step k, found from a
    weight tensor with that tap alone nonzero), the gy row that tap meets
    for dx row t·s + ph - y_off by conv1d_input's definition ((u + pad_l -
    j) / s) is t - pad + k for every phase: one A window serves all s
    phases. The taps a phase lacks are zero columns at its front."""
    B, T, ci, co, k, s, g, pd = case
    geo = dx_geometry(T, k, s, pd)
    cig, cog = ci // g, co // g
    cogp = -(-cog // 16) * 16
    for j in range(k):
        w = torch.zeros(co, cig, k)
        w[:, :, j] = 1.0
        wq = kernel_weights_bf16_dx(w, g, s).float().reshape(g, s, cig, geo.kp, cogp)
        ph = j % s
        nz = wq[:, :, :, :, :cog].sum(dim=(0, 2, 4))                 # [s, kp]
        assert int((nz != 0).sum()) == 1 and float(nz[ph].sum()) == g * cig * cog
        kk = int(nz[ph].nonzero()[0, 0])
        assert kk == geo.kp - 1 - j // s and kk >= geo.kp - phase_taps(k, s, ph)
        for t in range(geo.t_m):
            u = t * s + ph - geo.y_off
            assert (u + pd - j) % s == 0 and (u + pd - j) // s == t - geo.pad + kk
    for ph in range(s):
        w = torch.ones(co, cig, k)
        wq = kernel_weights_bf16_dx(w, g, s).float().reshape(g, s, cig, geo.kp, cogp)
        lead = geo.kp - phase_taps(k, s, ph)
        assert not wq[:, ph, :, :lead].any() and wq[:, ph, :, lead:, :cog].all()


@pytest.mark.parametrize("case", DX_CASES)
def test_dx_plan_is_the_phases_forward_plan(case):
    """The plan runs the forward kernel's tiling (its own CPU test covers
    that tiling) on one conv of gy whose s·cig out-channels a group are the
    phases side by side, among the input gradient's instantiated tiles;
    every phase has a tap and its taps are those j ≡ ph (mod s)."""
    B, T, ci, co, k, s, g, pd = case
    T_out = (T + 2 * pd - k) // s + 1
    geo, plan = bf16_dx_plan(B, T, ci, T_out, co, g, k, s, pd)
    assert plan.smem <= SMEM_LIMIT
    assert (plan.bn, -(-(co // g) // 16) * 16) in BF16_DX_TILES
    assert plan.n_tiles == -(-B * -(-geo.t_m // 64) // plan.mb) * g * (s * ci // g // plan.bn)
    assert sum(phase_taps(k, s, ph) for ph in range(s)) == k
    assert all(1 <= phase_taps(k, s, ph) <= geo.kp for ph in range(s))
    # the phases' outputs reach dx rows 0 and T - 1
    assert -geo.y_off <= 0 and (geo.t_m - 1) * s + s - 1 - geo.y_off >= T - 1


# ---------------------------------------------------------------------------
# K2-bf16 dw: splits of 64-row chunks, runs of B taps, gy's shifts in M
# ---------------------------------------------------------------------------

WGRAD_RAGGED = [
    # B, T, ci, co, k, s, g, pad: T_out 7, 121 (no multiple of 64), 1, 65; T_out
    # 64 exactly under 2 and 4 shifts (the shifted rows reach a chunk past it);
    # stride 8; one chunk in all
    (3, 13, 128, 128, 41, 2, 4, 20),
    (5, 121, 1024, 1024, 41, 1, 16, 20),
    (7, 1, 512, 1024, 41, 4, 16, 20),
    (4, 129, 128, 256, 41, 2, 16, 20),
    (2, 128, 128, 128, 41, 2, 4, 20),
    (1, 128, 128, 256, 41, 2, 16, 20),
    (2, 70, 64, 128, 9, 8, 4, 4),
    (1, 20, 64, 128, 5, 2, 4, 2),
]


def _wgrad_cases():
    return ([(TRAIN_B, *geo) for geo in _msd_geometries(TRAIN_T)] + WGRAD_RAGGED)


def _runs(plan, k, s):
    """Each tile's run of B taps: (its B taps, its first tap j_lo, its last
    tap j_hi with the shifts, the window's span of B taps)."""
    return [(bts, j_lo, j_hi, bts[-1] - j_lo + 1)
            for bts, j_lo, j_hi in wgrad_runs(k, s, plan.shifts, plan.nwg * plan.tpw)]


def _b_tap_of(j, s, shifts):
    """The B tap whose shift gives tap j (groupconv_bwd.cu:b_tap_of)."""
    period = shifts * s
    return j - (j % period) // s * s


@pytest.mark.parametrize("case", _wgrad_cases())
def test_wgrad_split_covers_every_row_and_tap_once(case):
    """Every row t of B·T_out meets each shift d once (as chunk row t + d of
    one chunk of one split), every split has a chunk, every tap is one B tap
    and shift of one run and is stored by that run alone (the membership the
    kernel's store tests in a tile's dw order of ``span`` taps), every run's
    window fits its staging rows; the tiles split only where they fill less
    than half the card, then with every block resident at once."""
    B, T, ci, co, k, s, g, pd = case
    T_out = (T + 2 * pd - k) // s + 1
    plan = bf16_wgrad_plan(B, T_out, ci, co, g, k, s, H100_SMS)
    cpr = -(-(T_out + plan.shifts - 1) // WGRAD_ROWS)
    assert plan.n_chunks == B * cpr and 1 <= plan.splits <= plan.n_chunks
    covered = np.zeros((plan.shifts, B, T_out), np.int64)
    for sp in range(plan.splits):
        chunks = wgrad_split(plan.n_chunks, plan.splits, sp)
        assert len(chunks) >= 1
        for c in chunks:
            b, t0 = divmod(c, cpr)
            for d in range(plan.shifts):
                rows = np.arange(t0 * WGRAD_ROWS, (t0 + 1) * WGRAD_ROWS) - d
                rows = rows[(rows >= 0) & (rows < T_out)]
                covered[d, b, rows] += 1
    np.testing.assert_array_equal(covered, 1)
    hit, stored = np.zeros(k, np.int64), np.zeros(k, np.int64)
    runs = _runs(plan, k, s)
    assert len(runs) == plan.n_tb and plan.n_tiles == g * plan.n_tb
    for bts, j_lo, j_hi, window in runs:
        assert 1 <= len(bts) <= plan.nwg * plan.tpw and j_hi - j_lo + 1 <= plan.span <= 64
        assert (WGRAD_ROWS - 1) * s + window <= plan.stg_rows
        for j in bts:
            for d in range(plan.shifts):
                if j + d * s < k:
                    assert j_lo <= j + d * s <= j_hi
                    hit[j + d * s] += 1
        for j in range(j_lo, j_hi + 1):
            stored[j] += _b_tap_of(j, s, plan.shifts) in bts
    np.testing.assert_array_equal(hit, 1)
    np.testing.assert_array_equal(stored, 1)
    boxes = -(-plan.stg_rows // WGRAD_MAX_BOX_ROWS)   # x's TMA boxes, ROW_BOX rows a multiple
    assert plan.stg_rows % (ROW_BOX * boxes) == 0 and plan.stg_rows // boxes <= 256
    assert plan.smem <= SMEM_LIMIT   # and the accumulators in a consumer's registers:
    assert plan.tpw * (ci // g) // 2 + 24 <= WGRAD_CONSUMER_REGS
    assert plan.smem == wgrad_smem(ci // g, co // g, s, plan.stg_rows, plan.stages, plan.span)
    assert 2 <= plan.stages <= WGRAD_MAX_STAGES and 1 <= plan.nwg <= WGRAD_MAX_WARPGROUPS
    if plan.splits > 1:
        assert 2 * plan.n_tiles <= H100_SMS and plan.n_tiles * plan.splits <= H100_SMS
        assert plan.ws_floats == plan.n_tiles * plan.splits * (co // g) * (ci // g) * plan.span
    else:
        assert plan.ws_floats == 0


def _dw_as_staged(x, gy, k, s, g, pd, plan):
    """dw as K2-bf16 dw computes it, in float64: each block's chunks staged
    box by box from x (zero outside [0, T)) and gy (its rows from 16 before
    the chunk, zero outside [0, T_out)), A's row (d, o) gy's row t - d, tap
    j's B the window rows t·s + j - j_lo; a block's sums into its tile's dw
    order [o][ci][tap - j_lo]; an unsplit tile stored, a split tile's
    partial sums added up a share of its rows at a time over the splits in
    split order,
    each tap stored by the run whose B tap it is."""
    B, T, Ci = x.shape
    T_out, Co = gy.shape[1], gy.shape[2]
    cig, cog = Ci // g, Co // g
    cpr = -(-(T_out + plan.shifts - 1) // WGRAD_ROWS)
    lead = plan.stg_rows + pd
    x_pad = np.zeros((B, T + 2 * lead + k, Ci))
    x_pad[:, lead:lead + T] = x
    gy_pad = np.zeros((B, WGRAD_GY_LEAD + cpr * WGRAD_ROWS, Co))
    gy_pad[:, WGRAD_GY_LEAD:WGRAD_GY_LEAD + T_out] = gy
    t = np.arange(WGRAD_ROWS)
    dw = np.full((Co, cig, k), np.nan)
    for gg in range(g):
        gy_g = gy_pad[:, :, gg * cog:(gg + 1) * cog]
        for bts, j_lo, j_hi, window in _runs(plan, k, s):
            part = np.zeros((plan.splits, cog, cig, plan.span))
            for sp in range(plan.splits):
                for c in wgrad_split(plan.n_chunks, plan.splits, sp):
                    b, t0 = divmod(c, cpr)
                    t0 *= WGRAD_ROWS
                    # A: [shift d, o, t] = gy[t0 + t - d, o]
                    a = np.stack([gy_g[b, WGRAD_GY_LEAD + t0 + t - d].T
                                  for d in range(plan.shifts)])
                    in0 = t0 * s - pd + j_lo
                    n_boxes = -(-((WGRAD_ROWS - 1) * s + window) // ROW_BOX)
                    staged = x_pad[b, lead + in0:lead + in0 + n_boxes * ROW_BOX,
                                   gg * cig:(gg + 1) * cig]
                    for j in bts:
                        bj = staged[t * s + j - j_lo]                   # [t, ci]
                        for d in range(plan.shifts):
                            if j + d * s < k:
                                part[sp, :, :, j + d * s - j_lo] += a[d] @ bj
            rows = part.reshape(plan.splits, cog * cig, plan.span)
            total = np.zeros((cog * cig, plan.span))
            for sp in range(plan.splits):
                share = wgrad_share(cog * cig, plan.splits, sp)
                v = rows[0, share.start:share.stop]
                for q in range(1, plan.splits):
                    v = v + rows[q, share.start:share.stop]
                total[share.start:share.stop] = v
            total = total.reshape(cog, cig, plan.span)
            for j in range(j_lo, j_hi + 1):
                if _b_tap_of(j, s, plan.shifts) in bts:
                    dw[gg * cog:(gg + 1) * cog, :, j] = total[:, :, j - j_lo]
    return dw


@pytest.mark.parametrize("case", WGRAD_RAGGED + [(3, 200, 128, 128, 41, 2, 4, 20),
                                                 (2, 120, 256, 512, 41, 4, 16, 20)])
def test_wgrad_staged_equals_the_plain_version(case):
    """The weight gradient summed as the kernel stages, shifts, orders and
    splits it, in float64, against the plain version on the same rounded
    operands, at fp32's sum-order error; every element written."""
    B, T, ci, co, k, s, g, pd = case
    x, w, gy = _conv_inputs(B, T, ci, co, k, s, g, pd, seed=sum(case))
    plan = bf16_wgrad_plan(B, gy.shape[1], ci, co, g, k, s, H100_SMS)
    got = _dw_as_staged(x.astype(np.float64), gy.astype(np.float64), k, s, g, pd, plan)
    assert not np.isnan(got).any()
    want = grouped_conv1d_bf16_weight_grad_reference(
        torch.from_numpy(x), torch.from_numpy(gy), w.shape, stride=s, padding=(pd, pd),
        groups=g)
    torch.testing.assert_close(torch.from_numpy(got).float(), want, rtol=1e-5, atol=1e-4)


def test_grad_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="channels per group"):
        bf16_wgrad_plan(2, 100, 64, 32, 4, 41, 2, H100_SMS)        # cog 8
    with pytest.raises(ValueError, match="channels per group"):
        bf16_wgrad_plan(2, 100, 1024, 1024, 8, 41, 1, H100_SMS)    # cig 128
    with pytest.raises(ValueError, match="channels per group"):
        bf16_wgrad_plan(2, 100, 96, 64, 4, 9, 1, H100_SMS)         # cig 24: not built
    with pytest.raises(ValueError, match="stride 3"):
        bf16_wgrad_plan(2, 100, 128, 128, 4, 41, 3, H100_SMS)
    with pytest.raises(ValueError, match="shared memory"):
        bf16_wgrad_plan(2, 100, 1024, 1024, 16, 41, 8, H100_SMS)   # a 512-row window of 64
    with pytest.raises(ValueError, match="every phase a tap"):
        bf16_dx_plan(2, 100, 128, 30, 128, 4, 3, 4, 1)             # K 3 < stride 4
    with pytest.raises(ValueError, match="every phase a tap"):
        bf16_dx_plan(2, 100, 128, 50, 128, 4, 41, 2, -1)           # a negative pad
    with pytest.raises(ValueError, match="channels per group"):
        bf16_dx_plan(2, 100, 128, 50, 512, 4, 41, 2, 20)           # cog 128: the phases' cig
    with pytest.raises(ValueError, match="channels per group"):
        bf16_dx_plan(2, 100, 128, 50, 48, 4, 41, 2, 20)            # cog 12: the phases' cig


def test_wgrad_plan_is_what_the_kernel_builds():
    """The plan chooses and the C entry only checks; the kernel's
    compile-time side must still be the plan's: its instantiations (cig,
    cog, tpw) are WGRAD_TPW's, its chunk rows, gy lead, staging depth,
    warpgroup cap and TMA box rows the plan's constants (a mismatch shows
    only on the card, as a refused launch), the registers its converter
    and the one reduction launch of the first design is gone."""
    src = (CSRC / "groupconv_bwd.cu").read_text()
    built = re.search(r"#define K2BF16_WGRAD_BUILT\(X\)(.*?)\n\n", src, re.S).group(1)
    assert {(int(a), int(b)): int(c)
            for a, b, c in re.findall(r"X\((\d+), (\d+), (\d+)\)", built)} == WGRAD_TPW
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src + (CSRC / "k2bf16.cuh").read_text())}
    assert (consts["kRc"], consts["kGyLead"], consts["kMaxStages"], consts["kMaxWarpgroups"],
            consts["kRowBox"], consts["kTileSlots"], consts["kMaxBoxRows"]) == (
        WGRAD_ROWS, WGRAD_GY_LEAD, WGRAD_MAX_STAGES, WGRAD_MAX_WARPGROUPS, ROW_BOX,
        WGRAD_TILE_SLOTS, WGRAD_MAX_BOX_ROWS)
    # the registers the producer warpgroup hands the consumers: within the
    # SM's 65536, and holding each instantiation's accumulators
    assert consts["kConsumerRegs"] == WGRAD_CONSUMER_REGS
    assert 128 * (consts["kProducerRegs"] + WGRAD_MAX_WARPGROUPS * WGRAD_CONSUMER_REGS) <= 65536
    assert all(tpw * cig // 2 + 24 <= WGRAD_CONSUMER_REGS for (cig, _), tpw in WGRAD_TPW.items())
    assert "reduce_kernel" not in src and src.count("<<<") == 1


def test_dx_tiles_are_what_the_kernel_builds():
    """The input gradient's tiles (BF16_DX_TILES) are csrc/groupconv.cu's
    K2BF16_DX_TILES, built with the dx epilogue."""
    src = (CSRC / "groupconv.cu").read_text()
    body = re.search(r"#define K2BF16_DX_TILES\(X\)(.*?)\n\n", src, re.S).group(1)
    tiles = [tuple(map(int, t)) for t in re.findall(
        r"X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)", body)]
    assert {t[:2]: t[2:] for t in tiles} == BF16_DX_TILES and len(tiles) == len(BF16_DX_TILES)


@pytest.mark.parametrize("case", _msd_geometries(TRAIN_T))
def test_wgrad_plan_follows_the_card_size(case):
    """dw's splits come from the card's SM count: on a card of the full or
    half the SMs, a plan splits only where its tiles fill less than half of
    it, then keeps every block resident (a block an SM), never more splits
    than chunks; a card of half the SMs never gets more splits of the same
    tiles; the B taps, shifts and chunks do not depend on it."""
    T, ci, co, k, s, g, pd = case
    T_out = (T + 2 * pd - k) // s + 1
    plans = {sms: bf16_wgrad_plan(TRAIN_B, T_out, ci, co, g, k, s, sms)
             for sms in (H100_SMS, H100_SMS // 2)}
    for sms, p in plans.items():
        assert 1 <= p.splits <= p.n_chunks
        assert (p.splits == 1) == (2 * p.n_tiles > sms)
        assert p.splits == 1 or p.n_tiles * p.splits <= sms
    full, half = plans[H100_SMS], plans[H100_SMS // 2]
    if half.n_tiles == full.n_tiles:
        assert half.splits <= full.splits
    assert (half.nbt, half.shifts, half.n_chunks) == (full.nbt, full.shifts, full.n_chunks)
