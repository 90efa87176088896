"""K3, the "default" rung's dense conv1d (``conan_tpu_torch/ops/denseconv.py``),
on the CPU: its plain versions (value, dx, dw) against the JAX package's
``conan_tpu.ops.conv.conv1d`` and ``causal_conv1d`` on bf16-rounded inputs;
the kernels' weight layouts, tap windows and dw tiling rebuilt in plain
torch; the plans and the route's predicate; the CPU route at "default".

The JAX package's DEFAULT precision on bf16-rounded fp32 inputs is exact
products summed in fp32; the plain versions sum the same products in fp32
in another order, so they agree to a relative L2 of 1e-5 (measured ~1e-7).
Inputs are made from a seed with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conan_tpu.ops.conv import causal_conv1d as jax_causal_conv1d
from conan_tpu.ops.conv import conv1d as jax_conv1d

from conan_tpu_torch.ops import conv as conv_ops
from conan_tpu_torch.ops import denseconv as dc
from conan_tpu_torch.ops.precision import training_scope

from tests.torch_port_util import one_torch_thread  # noqa: F401

REL = 1e-5
CPU = torch.device("cpu")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _rnd(a: np.ndarray) -> np.ndarray:
    """fp32 ``a`` rounded to bf16 and back, as the port's ``_rnd``."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _operands(case, seed):
    B, T, Ci, Co, K, d, pl, pr = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, Ci)).astype(np.float32)
    w = (rng.standard_normal((Co, Ci, K)) / np.sqrt(Ci * K)).astype(np.float32)
    b = (0.1 * rng.standard_normal(Co)).astype(np.float32)
    gy = rng.standard_normal((B, T + pl + pr - d * (K - 1), Co)).astype(np.float32)
    return x, w, b, gy


# (B, T, Ci, Co, K, dilation, pad_l, pad_r): symmetric k = 3 and 31, causal
# k = 5 (pad_r 0), causal dilated k = 3 at dilation 5, k = 1, dilated
# symmetric k = 5, causal k = 5 at dilation 60 (K3's window then takes
# its taps in two runs), channels past 64 (two chunks, the second mostly
# the zeros past C)
CASES = [(2, 40, 16, 24, 3, 1, 1, 1), (1, 50, 8, 16, 31, 1, 15, 15), (2, 33, 16, 8, 5, 1, 4, 0),
         (2, 37, 8, 16, 3, 5, 10, 0), (3, 20, 24, 16, 1, 1, 0, 0), (1, 45, 16, 16, 5, 2, 4, 4),
         (1, 300, 8, 16, 5, 60, 240, 0), (1, 70, 80, 40, 3, 1, 1, 1)]
# and a left pad past dilation*(K-1): dx's window starts past its rows
# (pad_l negative)
LAYOUT_CASES = CASES + [(2, 40, 16, 24, 3, 1, 5, 0)]


@pytest.mark.parametrize("case", CASES)
def test_plain_versions_match_jax_conv1d(case):
    """Value, dx and dw of the plain versions (the CPU route) against JAX's
    conv1d (causal_conv1d where pad_r is 0) and its VJP on the rounded
    x, w and incoming gradient."""
    B, T, Ci, Co, K, d, pl, pr = case
    x, w, b, gy = _operands(case, seed=sum(case))
    conv = dict(dilation=d, padding=(pl, pr))

    def jax_fn(xx, ww):
        if pr == 0 and pl == d * (K - 1):
            return jax_causal_conv1d(xx, ww, jnp.asarray(b), dilation=d)
        return jax_conv1d(xx, ww, jnp.asarray(b), dilation=d, padding=(pl, pr))

    y_j, vjp = jax.vjp(jax_fn, jnp.asarray(_rnd(x)), jnp.asarray(_rnd(w)))
    dx_j, dw_j = vjp(jnp.asarray(_rnd(gy)))
    t = [torch.from_numpy(a) for a in (x, w, b, gy)]
    y = dc.dense_conv1d_bf16_reference(t[0], t[1], t[2], **conv)
    dx = dc.dense_conv1d_bf16_input_grad_reference(t[3], t[1], x.shape, **conv)
    dw = dc.dense_conv1d_bf16_weight_grad_reference(t[0], t[3], w.shape, **conv)
    for name, got, want in (("y", y, y_j), ("dx", dx, dx_j), ("dw", dw, dw_j)):
        assert got.dtype == torch.float32
        assert got.shape == want.shape, name
        assert _rel(got, want) <= REL, name


def _emulate(src: torch.Tensor, wq: torch.Tensor, C: int, K: int, d: int, pad_l: int,
             T_out: int, plan=None) -> torch.Tensor:
    """What csrc/denseconv.cu computes, in float64, as dense_plan tiles it:
    for each m64 slot (64 output rows t0 .. of one batch row), 64-channel
    chunk c and run r of plan.tpr taps, the slot's window of plan.win_rows
    rows from t0 + r*tpr*d - pad_l (zero outside [0, T) and past C, as TMA
    fills); tap j's A the window's rows (j - r*tpr)*d on, times the
    layout's 64 columns (j*nci + c)*64 .. (zero past C)."""
    B, T, _ = src.shape
    N = wq.shape[0]
    nci = -(-C // 64)
    slots = -(-T_out // dc.SLOT)
    plan = plan or dc.dense_plan(C, N, K, d, B * slots, 132)
    runs = -(-K // plan.tpr)
    assert runs * plan.tpr >= K and plan.win_rows >= dc.SLOT + (plan.tpr - 1) * d
    xs = src.double()
    y = torch.zeros(B, slots * dc.SLOT, N, dtype=torch.float64)
    for slot in range(slots):
        t0 = slot * dc.SLOT
        for c in range(nci):
            for r in range(runs):
                rows = torch.arange(plan.win_rows) + t0 + r * plan.tpr * d - pad_l
                ok = (rows >= 0) & (rows < T)
                win = torch.zeros(B, plan.win_rows, 64, dtype=torch.float64)
                win[:, ok, :min(64, C - 64 * c)] = xs[:, rows[ok], 64 * c:64 * c + 64]
                for j in range(r * plan.tpr, min(K, (r + 1) * plan.tpr)):
                    o = (j - r * plan.tpr) * d
                    col = (j * nci + c) * 64
                    y[:, t0:t0 + dc.SLOT] += win[:, o:o + dc.SLOT] @ \
                        wq[:, col:col + 64].double().T
    return y[:, :T_out]


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_weight_layouts_rebuild_the_conv_and_its_input_gradient(case):
    """kernel_weights (the forward's layout) over dense_plan's windows and
    taps is the conv of the rounded operands; kernel_weights_dx over gy's
    windows padded by dilation*(K-1) - pad_l (negative where pad_l is past
    it) is its input gradient; both in float64 to 1e-12, and the layouts'
    padding channels are zero. The windows also as a plan of one tap a run
    (a window of 64 rows, every tap its own run)."""
    B, T, Ci, Co, K, d, pl, pr = case
    x, w, _b, gy = (torch.from_numpy(a) for a in _operands(case, seed=7 + sum(case)))
    conv = dict(dilation=d, padding=(pl, pr))
    wq, wq_dx = dc.kernel_weights(w), dc.kernel_weights_dx(w)
    assert wq.dtype == torch.bfloat16 and wq.shape == (Co, K * dc._round_up(Ci, 64))
    assert wq_dx.shape == (Ci, K * dc._round_up(Co, 64))
    assert not wq.view(Co, K, -1)[:, :, Ci:].any() and not wq_dx.view(Ci, K, -1)[:, :, Co:].any()
    xr = x.to(torch.bfloat16)
    want = dc.dense_conv1d_bf16_reference(x.double(), w.double(), **conv)
    want_dx = dc.dense_conv1d_bf16_input_grad_reference(gy.double(), w.double(), x.shape, **conv)
    one_tap = dc.DensePlan(128, 1, 1, 64, 4, 2, 0, 0)
    for plan in (None, one_tap):
        y = _emulate(xr, wq, Ci, K, d, pl, gy.shape[1], plan)
        assert _rel(y, want) <= 1e-12
        dx = _emulate(gy.to(torch.bfloat16), wq_dx, Co, K, d, d * (K - 1) - pl, T, plan)
        assert _rel(dx, want_dx) <= 1e-12


def _fragment_coords(regs: int):
    """For each consumer thread u (256) and accumulator register rr of an
    m64n(2*regs) tile: (warpgroup, row m, column q), the wgmma layout."""
    u = torch.arange(dc.WGRAD_CONSUMERS)[:, None]
    rr = torch.arange(regs)[None, :]
    wg, wl, gid, tig = u // 128, (u // 32) % 4, (u % 32) // 4, u % 4
    m = wl * 16 + gid + 8 * ((rr // 2) % 2)
    q = 8 * (rr // 4) + 2 * tig + rr % 2
    return wg.expand(-1, regs), m, q


def _emulate_dw(x: torch.Tensor, gy: torch.Tensor, Co: int, K: int, d: int, pl: int,
                sms: int) -> tuple[torch.Tensor, object]:
    """What csrc/denseconv_bwd.cu computes, in float64, as dense_wgrad_plan
    tiles it: for each tile (in-channel tile, out-channel tile, run) and
    split, every chunk of 64 rows of one batch row: gy's rows for the
    tile's nb out-channels and each warpgroup's x window (its 64-channel box
    and taps: the same taps on two boxes, or two runs of tpw taps on one),
    tap p the window's rows p*dilation on (a tap past K repeats the last);
    the accumulators as the threads' registers; an unsplit tile stored from
    the registers, a split one through the workspace (element r of thread u
    at r*256 + u), each split adding its share of the elements over the
    splits in order and decoding each element's register back to dw. Every
    dw element must be written once (NaN left otherwise)."""
    B, T, Ci = x.shape
    T_out = gy.shape[1]
    plan = dc.dense_wgrad_plan(B, T_out, Ci, Co, K, d, sms)
    t = plan.tiles
    regs = t.nb // 2
    E = t.tpw * regs * dc.WGRAD_CONSUMERS
    xr, gr = x.to(torch.bfloat16).double(), gy.to(torch.bfloat16).double()
    cpr = -(-T_out // dc.WGRAD_ROWS)
    n_c, n_n = -(-Ci // (64 * t.xboxes)), -(-Co // t.nb)
    assert plan.n_tiles == n_c * n_n * t.runs and t.runs * t.taps >= K
    assert plan.ws_floats == (0 if plan.splits == 1 else plan.n_tiles * plan.splits * E)
    wg, m, q = _fragment_coords(regs)
    dw = torch.full((Co, Ci, K), float("nan"), dtype=torch.float64)
    written = torch.zeros(Co, Ci, K, dtype=torch.int64)

    def store(n, ci, j, v):
        ok = (j < K) & (ci < Ci) & (n < Co)
        dw[n[ok], ci[ok], j[ok]] = v[ok]
        written.index_put_((n[ok], ci[ok], j[ok]), torch.ones_like(n[ok]), accumulate=True)

    for tile in range(plan.n_tiles):
        ct, nt, run = tile % n_c, (tile // n_c) % n_n, tile // (n_c * n_n)
        c0, n0, j0 = ct * 64 * t.xboxes, nt * t.nb, run * t.taps
        xq = [w if t.xboxes == 2 else 0 for w in (0, 1)]
        tb0 = [0 if t.xboxes == 2 else w * t.tpw for w in (0, 1)]
        parts = []
        for sp in range(plan.splits):
            acc = torch.zeros(2, t.tpw, 64, t.nb, dtype=torch.float64)
            for c in range(sp * plan.n_chunks // plan.splits,
                           (sp + 1) * plan.n_chunks // plan.splits):
                b, t0 = c // cpr, (c % cpr) * dc.WGRAD_ROWS
                g = torch.zeros(dc.WGRAD_ROWS, t.nb, dtype=torch.float64)
                gsl = gr[b, t0:t0 + dc.WGRAD_ROWS, n0:n0 + t.nb]
                g[:gsl.shape[0], :gsl.shape[1]] = gsl
                rows = torch.arange(t.win_rows) + t0 + j0 * d - pl
                ok = (rows >= 0) & (rows < T)
                for w in (0, 1):
                    win = torch.zeros(t.win_rows, 64, dtype=torch.float64)
                    xsl = xr[b][rows[ok]][:, c0 + 64 * xq[w]:c0 + 64 * xq[w] + 64]
                    win[ok, :xsl.shape[1]] = xsl
                    for p in range(t.tpw):
                        o = (min(j0 + tb0[w] + p, K - 1) - j0) * d
                        acc[w, p] += win[o:o + dc.WGRAD_ROWS].T @ g
            # registers: reg[u, p, rr] = acc[wg(u), p, m(u, rr), q(u, rr)]
            reg = torch.stack([acc[wg, p, m, q] for p in range(t.tpw)], 1)
            parts.append(reg)
        # the coordinates of register (u, p, rr): tap, in-channel, out-channel
        p_idx = torch.arange(t.tpw)[None, :, None]
        j = j0 + torch.where(wg == 1, tb0[1], tb0[0])[:, None, :] + p_idx
        ci = c0 + torch.where(wg == 1, 64 * xq[1], 64 * xq[0])[:, None, :] + m[:, None, :]
        n = n0 + q[:, None, :].expand(-1, t.tpw, -1)
        ci = ci.expand(-1, t.tpw, -1)
        if plan.splits == 1:
            store(n.flatten(), ci.flatten(), j.flatten(), parts[0].flatten())
            continue
        ws = torch.stack([r.permute(1, 2, 0).reshape(-1) for r in parts])   # [split][E]
        for sp in range(plan.splits):
            lo, hi = sp * E // plan.splits, (sp + 1) * E // plan.splits
            e = torch.arange(lo, hi)
            v = ws[0, e].clone()
            for qq in range(1, plan.splits):
                v += ws[qq, e]
            r, u = e // dc.WGRAD_CONSUMERS, e % dc.WGRAD_CONSUMERS
            p, rr = r // regs, r % regs
            uwg, uwl, ugid, utig = u // 128, (u // 32) % 4, (u % 32) // 4, u % 4
            jj = j0 + (0 if t.xboxes == 2 else 1) * uwg * t.tpw + p
            cc = c0 + (64 if t.xboxes == 2 else 0) * uwg + uwl * 16 + ugid + 8 * ((rr // 2) % 2)
            nn = n0 + 8 * (rr // 4) + 2 * utig + rr % 2
            store(nn, cc, jj, v)
    assert torch.equal(written, torch.ones_like(written)), "each dw element written once"
    return dw, plan


@pytest.mark.parametrize("sms", [132, 4])
@pytest.mark.parametrize("case", [(3, 150, 16, 136, 11, 3, 30, 0), (2, 70, 8, 8, 5, 1, 2, 2),
                                  (1, 200, 72, 16, 1, 1, 0, 0), (2, 100, 24, 256, 3, 2, 4, 0),
                                  (1, 90, 16, 128, 31, 1, 15, 15)])
def test_weight_grad_tiling_rebuilds_dw(case, sms):
    """K3 dw's tiling as csrc/denseconv_bwd.cu walks it (_emulate_dw: the
    tiles, each warpgroup's x box and taps, the windows' tap offsets, the
    splits' partial sums in the workspace added in split order and decoded
    back to dw), in float64 on the rounded operands: every dw element once,
    equal to the plain version's to 1e-12; on a card of 132 SMs and of 4
    (whose split tiles take the workspace)."""
    B, T, Ci, Co, K, d, pl, pr = case
    x, w, _b, gy = (torch.from_numpy(a) for a in _operands(case, seed=3 + sum(case)))
    dw, plan = _emulate_dw(x, gy, Co, K, d, pl, sms)
    want = dc.dense_conv1d_bf16_weight_grad_reference(x.double(), gy.double(), w.shape,
                                                      dilation=d, padding=(pl, pr))
    assert _rel(dw, want) <= 1e-12
    assert 1 <= plan.splits <= plan.n_chunks


@pytest.mark.parametrize("Ci,Co,K,d,what", [
    (4, 16, 3, 1, "channels"), (16, 12, 3, 1, "channels"), (1, 128, 15, 1, "channels"),
    (1024, 1, 3, 1, "channels"), (16, 16, 0, 1, "taps"), (2048, 64, 7, 0, "dilation"),
    (64, 64, 4, -80, "dilation")])
def test_plans_raise_on_what_the_kernels_do_not_take(Ci, Co, K, d, what):
    """dense_plan and dense_wgrad_tiles raise ValueError for what K3, its dx
    or its dw does not take, and the route's predicate says no."""
    with pytest.raises(ValueError):
        dc.dense_plan(Ci, Co, K, d)
        dc.dense_plan(Co, Ci, K, d)
        dc.dense_wgrad_tiles(Ci, Co, K, d)
    assert not dc.dense_kernel_takes(Ci, Co, K, d), what


@pytest.mark.parametrize("Ci,Co,K,d", [(2048, 64, 7, 1), (64, 64, 4, 80), (8, 128, 31, 200)])
def test_plans_take_what_the_first_kernels_refused(Ci, Co, K, d):
    """What the first K3 dw refused, its kernels now take: an out-channel's
    C x K sums past 48 KB (they went through a reduction launch's shared
    memory; now each tile's own registers), windows past a TMA box (each
    kernel now takes its taps in runs whose windows fit, one tap a run at
    the least)."""
    assert dc.dense_kernel_takes(Ci, Co, K, d)
    fwd, dw = dc.dense_plan(Ci, Co, K, d), dc.dense_wgrad_tiles(Ci, Co, K, d)
    assert fwd.win_rows <= dc.MAX_WINDOW and dw.win_rows <= dc.MAX_WINDOW


def _source(name: str) -> str:
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "conan_tpu_torch", "csrc", name)) as f:
        return f.read()


def test_plans_match_the_kernels_built():
    """The plans choose among what the sources instantiate, with their
    constants: DENSE_TILES against denseconv.cu's DENSECONV_BUILT, kSlot,
    kChunk, kNwg, kMaxWindow; WGRAD_TPW against denseconv_bwd.cu's
    DENSECONV_WGRAD_BUILT, kRows, kMaxWindow, kConsumers."""
    import re

    fwd, bwd = _source("denseconv.cu"), _source("denseconv_bwd.cu")

    def built(src, name):
        body = re.search(rf"#define {name}\(X\)(.*?)\n\n", src, re.S).group(1)
        return [tuple(map(int, t)) for t in re.findall(r"X\((\d+), (\d+)\)", body)]

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert built(fwd, "DENSECONV_BUILT") == list(dc.DENSE_TILES)
    assert (const(fwd, "kSlot"), const(fwd, "kChunk"), const(fwd, "kNwg"),
            const(fwd, "kMaxWindow")) == (dc.SLOT, dc.CHUNK, dc.NWG, dc.MAX_WINDOW)
    assert {nb: tuple(t for b, t in built(bwd, "DENSECONV_WGRAD_BUILT") if b == nb)
            for nb in dc.WGRAD_TPW} == dc.WGRAD_TPW
    assert (const(bwd, "kRows"), const(bwd, "kMaxWindow"), const(bwd, "kConsumers")) == (
        dc.WGRAD_ROWS, dc.MAX_WINDOW, dc.WGRAD_CONSUMERS)


@pytest.mark.parametrize("K,d", [(1, 1), (2, 40), (5, 11), (11, 5), (31, 1), (31, 8), (16, 1),
                                 (4, 150)])
@pytest.mark.parametrize("C,N", [(256, 512), (512, 256), (32, 32), (8, 128), (1024, 1024),
                                 (80, 160)])
def test_dense_plan_constraints(C, N, K, d):
    """dense_plan's windows hold their run's taps in a TMA box (a multiple
    of 8 rows, at most 256, the fewest runs); its tile is built and its
    shared memory fits; it is the first of DENSE_TILES whose tiles reach
    half the card where one does, else the one with the most tiles, never
    64 wide where 128 wastes no more of N; 4 windows in flight where a
    window serves fewer than 4 taps and they fit, else 2."""
    for slots, sms in ((24 * 24, 132), (18, 132), (36, 132), (1, 1)):
        plan = dc.dense_plan(C, N, K, d, slots, sms)
        runs = -(-K // plan.tpr)
        assert plan.win_rows % 8 == 0 and plan.win_rows <= dc.MAX_WINDOW
        assert plan.win_rows >= dc.SLOT + (plan.tpr - 1) * d and runs * plan.tpr >= K
        assert runs == 1 or dc.SLOT + (-(-K // (runs - 1)) - 1) * d > dc.MAX_WINDOW
        assert (plan.bn, plan.mi) in dc.DENSE_TILES
        assert plan.smem == dc.dense_smem(plan.bn, plan.mi, plan.win_rows, plan.xstages) \
            <= dc.SMEM_LIMIT
        if plan.tpr >= 4:
            assert plan.xstages == 2
        else:
            assert plan.xstages == dc.DENSE_XSTAGES or dc.dense_smem(
                plan.bn, plan.mi, plan.win_rows, plan.xstages + 1) > dc.SMEM_LIMIT
        assert plan.tiles == -(-slots // (dc.NWG * plan.mi)) * -(-N // plan.bn)
        widths = (128, 64) if dc._round_up(N, 128) <= dc._round_up(N, 64) else (64,)
        tiles = {t: -(-slots // (dc.NWG * t[1])) * -(-N // t[0]) for t in dc.DENSE_TILES
                 if t[0] in widths and dc.dense_smem(*t, plan.win_rows) <= dc.SMEM_LIMIT}
        half = [t for t in tiles if 2 * tiles[t] >= sms]
        assert (plan.bn, plan.mi) == (half[0] if half else max(tiles, key=tiles.get))


@pytest.mark.parametrize("K,d", [(1, 1), (2, 40), (5, 1), (11, 5), (31, 1), (7, 3), (3, 200)])
@pytest.mark.parametrize("Ci,Co", [(256, 512), (512, 256), (32, 32), (8, 128), (1024, 1024),
                                   (80, 160), (1536, 1024)])
def test_dense_wgrad_plan_constraints(Ci, Co, K, d):
    """dense_wgrad_tiles: a built (nb, tpw), taps a block tpw * (3 -
    xboxes), at most 2K, its window in a TMA box, two stages at least in
    shared memory; dense_wgrad_plan: no split where the tiles fill half the
    card, else splits whose blocks are all resident at once (a block an SM)
    and at most one a chunk, the workspace only then."""
    t = dc.dense_wgrad_tiles(Ci, Co, K, d, 24 * 24)
    assert t.tpw in dc.WGRAD_TPW[t.nb] and t.xboxes in (1, 2)
    assert t.taps == t.tpw * (3 - t.xboxes) <= 2 * K and t.runs == -(-K // t.taps)
    assert t.win_rows % 8 == 0 and dc.WGRAD_ROWS + (t.taps - 1) * d <= t.win_rows <= 256
    assert 2 <= t.stages <= dc.WGRAD_STAGES
    assert t.smem == dc.wgrad_smem(t.nb, t.xboxes, t.win_rows, t.stages) <= dc.SMEM_LIMIT
    for B, T_out, sms in ((24, 1496, 132), (18, 125, 132), (1, 64, 132), (2, 300, 8)):
        plan = dc.dense_wgrad_plan(B, T_out, Ci, Co, K, d, sms)
        assert plan.n_chunks == B * -(-T_out // 64)
        assert plan.tiles == dc.dense_wgrad_tiles(Ci, Co, K, d, plan.n_chunks)
        if 2 * plan.n_tiles > sms:
            assert plan.splits == 1 and plan.ws_floats == 0
        else:
            assert plan.splits == min(plan.n_chunks, sms // plan.n_tiles)
            assert plan.n_tiles * plan.splits <= sms
            pt = plan.tiles
            assert plan.ws_floats == (0 if plan.splits == 1 else plan.n_tiles * plan.splits
                                      * pt.tpw * pt.nb // 2 * dc.WGRAD_CONSUMERS)


# the production geometries (Ci, Co, K, dilation) of the Conan, vocoder and
# postnet steps at "default" (tools/torch_denseconv_lab.py step0 lists them)
# and the route each takes
PRODUCTION_ROUTES = [((256, 512, 31, 1), True), ((512, 256, 1, 1), True), ((80, 160, 5, 1), True),
                     ((160, 80, 1, 1), True), ((256, 512, 2, 8), True), ((32, 32, 11, 5), True),
                     ((512, 2048, 16, 1), True), ((1024, 1024, 5, 1), True),
                     ((80, 512, 7, 1), True), ((64, 64, 4, 1), True), ((1, 128, 15, 1), False),
                     ((1024, 1, 3, 1), False), ((32, 1, 7, 1), False)]


@pytest.mark.parametrize("geometry,k3", PRODUCTION_ROUTES)
def test_production_geometries_take_the_expected_route(geometry, k3):
    assert dc.dense_kernel_takes(*geometry) is k3


def _spy(monkeypatch):
    calls = []
    real = conv_ops.denseconv

    def spy(x, w, b=None, **kw):
        f = kw.get("fold")        # conv2d's and conv_transpose1d's: the conv1d of their fold
        calls.append(f.geometry if f else (x.shape[-1], w.shape[0], w.shape[-1], kw["dilation"]))
        return real(x, w, b, **kw)

    monkeypatch.setattr(conv_ops, "denseconv", spy)
    return calls


def _small_step(task: str):
    """One step of ``task`` at small width at "default" on the CPU (the card
    tests' small configurations, tests/test_torch_cuda.py)."""
    import os

    from conan_tpu_torch.checkpoint import tree_map
    from conan_tpu_torch.config import load_config
    from conan_tpu_torch.models.conan.model import Conan, ConanConfig
    from conan_tpu_torch.train.tasks import ConanTask, PostnetTask

    from tests.test_torch_cuda import CONAN_SMALL, _conan_batch

    egs = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "egs",
                       "soak_r5")
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    if task == "vocoder":      # the generator and the MSD, the vocoder's conv1d layers
        from conan_tpu_torch.checkpoint import tree_leaves
        from conan_tpu_torch.models.vocoder.discriminators import MultiScaleDiscriminator
        from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig, HifiGanGenerator

        hp = dict(load_config(os.path.join(egs, "vocoder.yaml")), upsample_initial_channel=32)
        g, msd = HifiGanGenerator(HifiGanConfig.from_hparams(hp)), MultiScaleDiscriminator()
        params = [tree_map(lambda t: t.requires_grad_(True), m.init(gen)) for m in (g, msd)]
        mel = torch.from_numpy((rng.standard_normal((1, 4, 80)) - 4).astype(np.float32))
        with training_scope("default", CPU):
            outs, _ = msd.forward(params[1], g.apply(params[0], mel))
            return torch.autograd.grad(sum(o.sum() for o in outs), tree_leaves(params))
    if task == "conan":
        hp = {**load_config(os.path.join(egs, "conan.yaml")), **CONAN_SMALL,
              "train_precision": "default"}
        t = ConanTask(hp, device="cpu")
        return t.train_step(t.init_state(gen), _conan_batch(T=48, Tr=32), None,
                            use_random_ref=True)
    hp = {**load_config(os.path.join(egs, "postnet.yaml")), **CONAN_SMALL, "residual_layers": 2,
          "residual_channels": 16, "spec_min": [-8.0] * 80, "spec_max": [1.0] * 80,
          "train_precision": "default"}
    conan = Conan(ConanConfig.from_hparams(hp))
    frozen = tree_map(lambda t: t.numpy(), conan.init(gen))
    vq = tree_map(lambda t: t.numpy(), conan.init_vq_state(gen))
    t = PostnetTask(hp, frozen, vq, device="cpu")
    return t.train_step(t.init_state(gen), _conan_batch(T=48, Tr=32))


@pytest.mark.parametrize("task", ["conan", "vocoder", "postnet"])
def test_route_of_each_geometry_in_a_small_step(task, monkeypatch):
    """One step of each task at small width under "default" on the CPU:
    every dense conv1d call goes to K3's wrapper exactly where the
    predicate takes its shape (stride 1, both channel counts multiples of 8),
    the rest to rounded_dot (the vocoder's one-channel layers); K3's wrapper
    runs its plain version and launches nothing."""
    from chip_smoke import recording_convs

    calls = _spy(monkeypatch)
    before = (dc.denseconv.launches, dc.denseconv.launches_dx, dc.denseconv.launches_dw)
    with recording_convs() as seen:
        _small_step(task)
    routed = sorted((g[2], g[3], g[4], g[6]) for g, n in seen.items() for _ in range(n)
                    if g[5] == 1 and dc.dense_kernel_takes(g[2], g[3], g[4], g[6]))
    assert routed and sorted(calls) == routed
    rest = [g for g in seen if not dc.dense_kernel_takes(g[2], g[3], g[4], g[6])]
    assert all(min(g[2], g[3]) < 8 or g[2] % 8 or g[3] % 8 for g in rest)
    assert bool(rest) == (task == "vocoder")
    assert (dc.denseconv.launches, dc.denseconv.launches_dx, dc.denseconv.launches_dw) == before


def test_cpu_route_at_default_is_the_plain_version(monkeypatch):
    """ops.conv.conv1d under "default" on the CPU: K3's wrapper, whose
    value and gradients (dx, dw and the bias's) equal the plain versions'
    bit for bit, with no launch; outside "default" the plain fp32 conv."""
    case = (2, 45, 16, 24, 5, 2, 8, 0)
    x, w, b, gy = (torch.from_numpy(a) for a in _operands(case, seed=11))
    conv = dict(dilation=2, padding=(8, 0))
    calls = _spy(monkeypatch)
    xx, ww, bb = (t.clone().requires_grad_(True) for t in (x, w, b))
    with training_scope("default", CPU):
        y = conv_ops.conv1d(xx, ww, bb, **conv)
        dx, dw, db = torch.autograd.grad(y, (xx, ww, bb), gy)
    assert len(calls) == 1 and dc.denseconv.launches == 0
    assert torch.equal(y, dc.dense_conv1d_bf16_reference(x, w, b, **conv))
    assert torch.equal(dx, dc.dense_conv1d_bf16_input_grad_reference(gy, w, x.shape, **conv))
    assert torch.equal(dw, dc.dense_conv1d_bf16_weight_grad_reference(x, gy, w.shape, **conv))
    assert torch.equal(db, gy.sum((0, 1)))
    y32 = conv_ops.conv1d(x, w, b, **conv)
    want = F.conv1d(F.pad(x.transpose(1, 2), (8, 0)), w, b, dilation=2).transpose(1, 2)
    assert len(calls) == 1 and torch.equal(y32, want)
