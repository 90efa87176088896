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
# symmetric k = 5
CASES = [(2, 40, 16, 24, 3, 1, 1, 1), (1, 50, 8, 16, 31, 1, 15, 15), (2, 33, 16, 8, 5, 1, 4, 0),
         (2, 37, 8, 16, 3, 5, 10, 0), (3, 20, 24, 16, 1, 1, 0, 0), (1, 45, 16, 16, 5, 2, 4, 4)]


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
             T_out: int) -> torch.Tensor:
    """What csrc/denseconv.cu computes, in float64: for each tap j the rows
    t + j*d - pad_l of src (zero outside, as TMA fills), times the layout's
    columns j*Cp .. j*Cp + C."""
    B, T, _ = src.shape
    Cp = wq.shape[1] // K
    y = torch.zeros(B, T_out, wq.shape[0], dtype=torch.float64)
    for j in range(K):
        rows = torch.arange(T_out) + j * d - pad_l
        ok = (rows >= 0) & (rows < T)
        a = torch.zeros(B, T_out, C, dtype=torch.float64)
        a[:, ok] = src[:, rows[ok]].double()
        y += a @ wq[:, j * Cp:j * Cp + C].double().T
    return y


@pytest.mark.parametrize("case", CASES)
def test_weight_layouts_rebuild_the_conv_and_its_input_gradient(case):
    """kernel_weights (the forward's layout) over the taps' row windows is
    the conv of the rounded operands; kernel_weights_dx over gy's windows
    padded by dilation*(K-1) - pad_l is its input gradient; both in float64
    to 1e-12, and the layouts' padding channels are zero."""
    B, T, Ci, Co, K, d, pl, pr = case
    x, w, _b, gy = (torch.from_numpy(a) for a in _operands(case, seed=7 + sum(case)))
    conv = dict(dilation=d, padding=(pl, pr))
    wq, wq_dx = dc.kernel_weights(w), dc.kernel_weights_dx(w)
    assert wq.dtype == torch.bfloat16 and wq.shape == (Co, K * dc._round_up(Ci, 64))
    assert wq_dx.shape == (Ci, K * dc._round_up(Co, 64))
    assert not wq.view(Co, K, -1)[:, :, Ci:].any() and not wq_dx.view(Ci, K, -1)[:, :, Co:].any()
    xr = x.to(torch.bfloat16)
    y = _emulate(xr, wq, Ci, K, d, pl, gy.shape[1])
    want = dc.dense_conv1d_bf16_reference(x.double(), w.double(), **conv)
    assert _rel(y, want) <= 1e-12
    dx = _emulate(gy.to(torch.bfloat16), wq_dx, Co, K, d, d * (K - 1) - pl, T)
    want_dx = dc.dense_conv1d_bf16_input_grad_reference(gy.double(), w.double(), x.shape, **conv)
    assert _rel(dx, want_dx) <= 1e-12


@pytest.mark.parametrize("case", [(3, 150, 16, 136, 11, 3, 30, 0), (2, 70, 8, 8, 5, 1, 2, 2),
                                  (1, 200, 72, 16, 1, 1, 0, 0)])
def test_weight_grad_tiling_rebuilds_dw(case):
    """K3 dw's tiling as csrc/denseconv_bwd.cu walks it (dense_wgrad_plan's
    runs of taps, each a window from t0 + j0*dilation - pad_l; 64-row
    chunks of one batch row; the splits' partial sums added in order), in
    float64 on the rounded operands: dw of the plain version to 1e-12."""
    B, T, Ci, Co, K, d, pl, pr = case
    x, w, _b, gy = (torch.from_numpy(a) for a in _operands(case, seed=3 + sum(case)))
    T_out = gy.shape[1]
    plan = dc.dense_wgrad_plan(B, T_out, Ci, Co, K, d, sms=4)
    tiles = plan.tiles
    xr, gr = x.to(torch.bfloat16).double(), gy.to(torch.bfloat16).double()
    cpr = -(-T_out // dc.WGRAD_ROWS)
    part = torch.zeros(plan.splits, K, Co, Ci, dtype=torch.float64)
    for sp in range(plan.splits):
        for c in range(sp * plan.n_chunks // plan.splits, (sp + 1) * plan.n_chunks // plan.splits):
            b, t0 = c // cpr, (c % cpr) * dc.WGRAD_ROWS
            g = torch.zeros(dc.WGRAD_ROWS, Co, dtype=torch.float64)
            n = min(dc.WGRAD_ROWS, T_out - t0)
            g[:n] = gr[b, t0:t0 + n]
            for run in range(tiles.runs):
                j0 = run * tiles.tpw
                rows = torch.arange(tiles.win_rows) + t0 + j0 * d - pl
                ok = (rows >= 0) & (rows < T)
                win = torch.zeros(tiles.win_rows, Ci, dtype=torch.float64)
                win[ok] = xr[b, rows[ok]]
                for p in range(tiles.tpw):
                    j = j0 + p
                    if j < K:
                        part[sp, j] += g.T @ win[p * d:p * d + dc.WGRAD_ROWS]
    dw = part.sum(0).permute(1, 2, 0)
    want = dc.dense_conv1d_bf16_weight_grad_reference(x.double(), gy.double(), w.shape,
                                                      dilation=d, padding=(pl, pr))
    assert _rel(dw, want) <= 1e-12
    assert plan.part_floats == plan.splits * K * Co * Ci and 1 <= plan.splits <= plan.n_chunks


@pytest.mark.parametrize("Ci,Co,K,d,what", [
    (4, 16, 3, 1, "channels"), (16, 12, 3, 1, "channels"), (1, 128, 15, 1, "channels"),
    (1024, 1, 3, 1, "channels"), (16, 16, 0, 1, "taps"), (2048, 64, 7, 1, "sums"),
    (64, 64, 4, 80, "window")])
def test_plans_raise_on_what_the_kernels_do_not_take(Ci, Co, K, d, what):
    """dense_plan and dense_wgrad_tiles raise ValueError for what K3, its dx
    or its dw does not take, and the route's predicate says no."""
    with pytest.raises(ValueError):
        dc.dense_plan(Ci, Co, K)
        dc.dense_plan(Co, Ci, K)
        dc.dense_wgrad_tiles(Ci, Co, K, d)
    assert not dc.dense_kernel_takes(Ci, Co, K, d), what


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
