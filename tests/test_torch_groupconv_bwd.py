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

from conan_tpu_torch.ops.groupconv import (ROW_BOX, SMEM_LIMIT, WGRAD_GY_LEAD,
                                           WGRAD_MAX_WARPGROUPS, WGRAD_ROWS, WGRAD_STAGING,
                                           WGRAD_TPW, bf16_dx_plan,
                                           bf16_wgrad_plan, dx_geometry,
                                           grouped_conv1d_bf16_input_grad_reference,
                                           grouped_conv1d_bf16_weight_grad_reference,
                                           grouped_conv1d_reference, kernel_weights_bf16_dx,
                                           phase_taps, wgrad_b_taps, wgrad_split)
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
    """dx as K2-bf16 dx computes it, in float64: for each phase ph, the
    stride-1 grouped conv of gy with that phase's rows of the kernel's weight
    layout (kernel_weights_bf16_dx), its window pad rows to the left,
    output t stored at dx row t·s + ph - y_off. Returns dx and how often
    each row was written."""
    B, T_out, Co = gy.shape
    _, cig, K = w.shape
    Ci, cog = g * cig, Co // g
    geo = dx_geometry(T, K, s, pd)
    cogp = -(-cog // 16) * 16
    wq = kernel_weights_bf16_dx(w, g, s).double().reshape(s, Ci, geo.kp, cogp)
    dx = torch.zeros(B, T, Ci, dtype=torch.float64)
    written = torch.zeros(T, dtype=torch.int64)
    for ph in range(s):
        pad = geo.pad - (geo.kp - phase_taps(K, s, ph))
        w_ph = wq[ph, :, :, :cog].permute(0, 2, 1)                   # [Ci, cog, kp]
        # outputs t = 0 .. t_m - 1 read gy rows t - pad .. t - pad + kp - 1
        right = max(0, geo.t_m - 1 - pad + geo.kp - T_out)
        lead = max(0, pad)
        y = grouped_conv1d_reference(gy.double()[:, max(0, -pad):], w_ph, stride=1,
                                     padding=(lead, right), groups=g)[:, :geo.t_m]
        rows = torch.arange(geo.t_m) * s + ph - geo.y_off
        keep = (rows >= 0) & (rows < T)
        dx[:, rows[keep]] = y[:, keep]
        written[rows[keep]] += 1
    return dx, written


@pytest.mark.parametrize("case", DX_CASES)
def test_dx_phase_layout_recombines_to_conv1d_input(case):
    """Integer-valued w and gy (exact in bf16 and in every float64 sum): the
    phases' convs over the kernel's weight layout equal conv1d_input bit for
    bit, and every dx row is written once."""
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
def test_dx_plan_is_the_phases_forward_plan(case):
    """The plan runs the forward kernel's tiling on the phases' conv (its
    own CPU test covers that tiling), s phases a launch; every phase has a
    tap and its taps are those j ≡ ph (mod s)."""
    B, T, ci, co, k, s, g, pd = case
    T_out = (T + 2 * pd - k) // s + 1
    geo, plan = bf16_dx_plan(B, T, ci, T_out, co, g, k, s, pd)
    assert plan.smem <= SMEM_LIMIT
    assert plan.n_tiles == -(-B * -(-geo.t_m // 64) // plan.mb) * s * g * (ci // g // plan.bn)
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
    """Each block's run of B taps: (its taps, the first, the window's span)."""
    taps = wgrad_b_taps(k, s, plan.shifts)
    per = plan.nwg * plan.tpw
    return [(taps[t * per:(t + 1) * per], taps[t * per],
             taps[min(t * per + per, plan.nbt) - 1] - taps[t * per] + 1)
            for t in range(plan.n_tb)]


@pytest.mark.parametrize("case", _wgrad_cases())
def test_wgrad_split_covers_every_row_and_tap_once(case):
    """Every row t of B·T_out meets each shift d once (as chunk row t + d of
    one chunk of one split), every split has a chunk, every tap is one B tap
    and shift of one run, and every run's window fits its staging rows."""
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
    hit = np.zeros(k, np.int64)
    for taps, j_lo, span in _runs(plan, k, s):
        assert 1 <= len(taps) <= plan.nwg * plan.tpw
        assert (WGRAD_ROWS - 1) * s + span <= plan.stg_rows and plan.stg_rows % ROW_BOX == 0
        for j in taps:
            assert j_lo <= j < j_lo + span
            for d in range(plan.shifts):
                if j + d * s < k:
                    hit[j + d * s] += 1
    np.testing.assert_array_equal(hit, 1)
    assert plan.smem <= SMEM_LIMIT and plan.tpw * (ci // g) // 2 <= 128   # accumulators
    assert plan.part_floats == plan.splits * g * k * (ci // g) * (co // g)


def _dw_as_staged(x, gy, k, s, g, pd, plan):
    """dw as K2-bf16 dw computes it, in float64: each block's chunks staged
    box by box from x (zero outside [0, T)) and gy (its rows from 16 before
    the chunk, zero outside [0, T_out)), A's row (d, o) gy's row t - d, tap
    j's B the window rows t·s + j - j_lo, a partial sum a split, then the
    splits added in order."""
    B, T, Ci = x.shape
    T_out, Co = gy.shape[1], gy.shape[2]
    cig, cog = Ci // g, Co // g
    cpr = -(-(T_out + plan.shifts - 1) // WGRAD_ROWS)
    lead = plan.stg_rows + pd
    x_pad = np.zeros((B, T + 2 * lead + k, Ci))
    x_pad[:, lead:lead + T] = x
    gy_pad = np.zeros((B, WGRAD_GY_LEAD + cpr * WGRAD_ROWS, Co))
    gy_pad[:, WGRAD_GY_LEAD:WGRAD_GY_LEAD + T_out] = gy
    part = np.zeros((plan.splits, g, k, cig, cog))
    t = np.arange(WGRAD_ROWS)
    for sp in range(plan.splits):
        for c in wgrad_split(plan.n_chunks, plan.splits, sp):
            b, t0 = divmod(c, cpr)
            t0 *= WGRAD_ROWS
            for gg in range(g):
                gy_g = gy_pad[b, :, gg * cog:(gg + 1) * cog]
                # A: [shift d, o, t] = gy[t0 + t - d, o]
                a = np.stack([gy_g[WGRAD_GY_LEAD + t0 + t - d].T for d in range(plan.shifts)])
                for taps, j_lo, span in _runs(plan, k, s):
                    in0 = t0 * s - pd + j_lo
                    n_boxes = -(-((WGRAD_ROWS - 1) * s + span) // ROW_BOX)
                    staged = x_pad[b, lead + in0:lead + in0 + n_boxes * ROW_BOX,
                                   gg * cig:(gg + 1) * cig]
                    for j in taps:
                        bj = staged[t * s + j - j_lo]                   # [t, ci]
                        for d in range(plan.shifts):
                            if j + d * s < k:
                                part[sp, gg, j + d * s] += (a[d] @ bj).T
    total = part[0]
    for sp in range(1, plan.splits):
        total = total + part[sp]
    # [g, j, ci, o] -> [g * cog + o, ci, j]
    return total.transpose(0, 3, 2, 1).reshape(Co, cig, k)


@pytest.mark.parametrize("case", WGRAD_RAGGED + [(3, 200, 128, 128, 41, 2, 4, 20),
                                                 (2, 120, 256, 512, 41, 4, 16, 20)])
def test_wgrad_staged_equals_the_plain_version(case):
    """The weight gradient summed as the kernel stages, shifts and splits it,
    in float64, against the plain version on the same rounded operands, at
    fp32's sum-order error."""
    B, T, ci, co, k, s, g, pd = case
    x, w, gy = _conv_inputs(B, T, ci, co, k, s, g, pd, seed=sum(case))
    plan = bf16_wgrad_plan(B, gy.shape[1], ci, co, g, k, s, H100_SMS)
    got = _dw_as_staged(x.astype(np.float64), gy.astype(np.float64), k, s, g, pd, plan)
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
    with pytest.raises(ValueError, match="48 KB"):
        bf16_wgrad_plan(2, 100, 1024, 1024, 16, 200, 1, H100_SMS)  # 200 taps x 64
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
    cog, tpw) are WGRAD_TPW's, and its chunk rows, gy lead, staging depth,
    warpgroup cap and TMA box rows the plan's constants (a mismatch shows
    only on the card, as a refused launch)."""
    src = (CSRC / "groupconv_bwd.cu").read_text()
    built = re.search(r"#define K2BF16_WGRAD_BUILT\(X\)(.*?)\n\n", src, re.S).group(1)
    assert {(int(a), int(b)): int(c)
            for a, b, c in re.findall(r"X\((\d+), (\d+), (\d+)\)", built)} == WGRAD_TPW
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src + (CSRC / "k2bf16.cuh").read_text())}
    assert (consts["kRc"], consts["kGyLead"], consts["kStaging"], consts["kMaxWarpgroups"],
            consts["kRowBox"]) == (WGRAD_ROWS, WGRAD_GY_LEAD, WGRAD_STAGING,
                                   WGRAD_MAX_WARPGROUPS, ROW_BOX)


@pytest.mark.parametrize("case", _msd_geometries(TRAIN_T))
def test_wgrad_plan_follows_the_card_size(case):
    """dw's splits come from the card's SM count: a card of half the SMs
    gets at most half the splits (at least one), never more chunks than
    there are; the rest of the plan does not depend on it."""
    T, ci, co, k, s, g, pd = case
    T_out = (T + 2 * pd - k) // s + 1
    full = bf16_wgrad_plan(TRAIN_B, T_out, ci, co, g, k, s, H100_SMS)
    half = bf16_wgrad_plan(TRAIN_B, T_out, ci, co, g, k, s, H100_SMS // 2)
    assert 1 <= half.splits <= full.splits <= full.n_chunks
    assert half.splits >= full.splits // 2
    assert half._replace(splits=full.splits, part_floats=full.part_floats) == full
