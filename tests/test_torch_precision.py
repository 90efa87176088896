"""The port's training rungs (``conan_tpu_torch/ops/precision.py``) and
kernel K2-bf16's plain version, on the CPU.

JAX ignores ``lax.Precision.DEFAULT`` on the CPU, so no test can hold a
"default" step to JAX's. Instead each dot and conv under "default" is held to
the fp32 product of its bf16-rounded operands (rtol 1e-5: on the CPU the
port computes exactly that), with fp32 outputs; "highest" and "high" (no TF32
on the CPU) leave every op as it was, bit for bit. K2-bf16's plain version
(the fp32 grouped conv of the rounded operands) is held to the JAX package's
Pallas kernel in interpret mode handed bf16 operands, on the MSD's five
grouped geometries (tests/test_pallas_groupconv.py:15-21), at the tolerances
tests/test_torch_groupconv.py holds the fp32 route to (atol 2e-4, rtol
1e-4: fp32 sums in other orders). The kernel's weight layout is checked by
rebuilding the conv from it in float64.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conan_tpu.ops.pallas_groupconv import pallas_grouped_conv1d

from conan_tpu_torch.checkpoint import tree_leaves
from conan_tpu_torch.nn.blocks import MultiheadAttention, dense
from conan_tpu_torch.ops.conv import causal_conv1d, conv1d, conv2d
from conan_tpu_torch.ops.groupconv import (GroupConvKernel, grouped_conv1d_bf16_reference,
                                           grouped_conv1d_reference, kernel_weights_bf16)
from conan_tpu_torch.ops.precision import (TRAINING_RUNGS, bf16_dots, einsum_at_rung,
                                           training_scope)
from conan_tpu_torch.train.tasks import ConanTask, EmformerTask, VocoderTask

from tests.test_pallas_groupconv import MSD_LAYERS
from tests.test_train_steps import CONAN_HP, VOC_HP
from tests.torch_port_util import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
RTOL = 1e-5
ATOL, GC_RTOL = 2e-4, 1e-4


def _r(t: torch.Tensor) -> torch.Tensor:
    """bf16-rounded, back in fp32."""
    return t.to(torch.bfloat16).float()


def _randn(rng, *shape, scale=1.0) -> torch.Tensor:
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def test_rung_scopes_set_and_restore_the_policy():
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (matmul.allow_tf32, cudnn.allow_tf32, bf16_dots())
    want = {"default": (False, False, True), "high": (True, True, False),
            "highest": (False, False, False)}
    assert set(want) == set(TRAINING_RUNGS)
    for name, flags in want.items():
        with training_scope(name, CPU):
            assert (matmul.allow_tf32, cudnn.allow_tf32, bf16_dots()) == flags, name
        assert (matmul.allow_tf32, cudnn.allow_tf32, bf16_dots()) == before
    with pytest.raises(ValueError, match="train_precision"):
        with training_scope("fast", CPU):
            pass


def _ops(rng):
    """(name, the op at the rung, its fp32 version on given operands, operands)."""
    x, w, b = _randn(rng, 3, 7, 24), _randn(rng, 16, 24, scale=0.2), _randn(rng, 16)
    xc, wc, bc = _randn(rng, 2, 30, 12), _randn(rng, 20, 12, 5, scale=0.3), _randn(rng, 20)
    x2, w2, b2 = _randn(rng, 2, 3, 12, 10), _randn(rng, 8, 3, 3, 3, scale=0.3), _randn(rng, 8)
    a, c = _randn(rng, 2, 9, 4, 6), _randn(rng, 2, 11, 4, 6)
    conv_cf = lambda xx, ww, pad, dil: F.conv1d(  # noqa: E731
        F.pad(xx.transpose(1, 2), pad), ww, None, dilation=dil).transpose(1, 2)
    return [
        ("linear", lambda xx, ww: dense(xx, ww, b), lambda xx, ww: F.linear(xx, ww) + b, (x, w)),
        ("conv1d", lambda xx, ww: conv1d(xx, ww, bc, dilation=2, padding=(4, 4)),
         lambda xx, ww: conv_cf(xx, ww, (4, 4), 2) + bc, (xc, wc)),
        ("causal_conv1d", lambda xx, ww: causal_conv1d(xx, ww, bc),
         lambda xx, ww: conv_cf(xx, ww, (4, 0), 1) + bc, (xc, wc)),
        ("conv2d", lambda xx, ww: conv2d(xx, ww, b2, stride=2, padding=1),
         lambda xx, ww: F.conv2d(xx, ww, stride=2, padding=1) + b2[:, None, None], (x2, w2)),
        ("einsum", lambda aa, cc: einsum_at_rung("bqhd,bkhd->bhqk", aa, cc),
         lambda aa, cc: torch.einsum("bqhd,bkhd->bhqk", aa, cc), (a, c)),
    ]


def test_default_rung_dots_are_fp32_products_of_bf16_rounded_operands():
    """Each dot and conv under "default": the fp32 op on the rounded
    operands (bias added in fp32), an fp32 result; its gradients are the
    same dots with the incoming gradient rounded too, as JAX's DEFAULT
    transposes. Under "highest" and "high" the op is the plain fp32 op,
    exactly."""
    rng = np.random.default_rng(0)
    for name, op, plain, operands in _ops(rng):
        for rung in ("highest", "high"):
            with training_scope(rung, CPU):
                torch.testing.assert_close(op(*operands), plain(*operands), rtol=0, atol=0,
                                           msg=f"{name} at {rung}")
        ins = [t.clone().requires_grad_(True) for t in operands]
        with training_scope("default", CPU):
            y = op(*ins)
        assert y.dtype == torch.float32, name
        want = plain(*(_r(t) for t in operands))
        torch.testing.assert_close(y, want, rtol=RTOL, atol=1e-6, msg=name)
        assert not torch.equal(y, plain(*operands)), f"{name}: the rung changed nothing"
        gy = _randn(rng, *y.shape)
        got = torch.autograd.grad(y, ins, gy)
        ref_ins = [_r(t).requires_grad_(True) for t in operands]
        want_g = torch.autograd.grad(plain(*ref_ins), ref_ins, _r(gy))
        for g, wg in zip(got, want_g):
            assert g.dtype == torch.float32
            torch.testing.assert_close(g, wg, rtol=RTOL, atol=1e-6, msg=f"{name} grad")


def test_default_rung_attention_rounds_every_dot():
    """The aligner's multi-head attention under "default": every projection
    and both attention products on rounded operands, softmax in fp32."""
    rng = np.random.default_rng(1)
    D, H = 16, 2
    mha = MultiheadAttention(D, H)
    p = {"in_w": _randn(rng, 3 * D, D, scale=0.3), "in_b": _randn(rng, 3 * D, scale=0.1),
         "out": {"w": _randn(rng, D, D, scale=0.3), "b": _randn(rng, D, scale=0.1)}}
    q, kv = _randn(rng, 2, 5, D), _randn(rng, 2, 7, D)
    with training_scope("default", CPU):
        got = mha.apply(p, q, kv, kv)

    def lin(x, w, b):
        return F.linear(_r(x), _r(w)) + b

    W, b = p["in_w"], p["in_b"]
    qh = lin(q, W[:D], b[:D]).reshape(2, 5, H, D // H)
    kh = lin(kv, W[D:2 * D], b[D:2 * D]).reshape(2, 7, H, D // H)
    vh = lin(kv, W[2 * D:], b[2 * D:]).reshape(2, 7, H, D // H)
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", _r(qh), _r(kh)) * (D // H) ** -0.5, -1)
    o = torch.einsum("bhqk,bkhd->bqhd", _r(probs), _r(vh)).reshape(2, 5, D)
    torch.testing.assert_close(got, lin(o, p["out"]["w"], p["out"]["b"]), rtol=RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# K2-bf16's plain version, its CPU route and its weight layout
# ---------------------------------------------------------------------------

def _gc_inputs(ci, co, k, g, seed):
    rng = np.random.default_rng(seed)
    T = 120 if ci <= 256 else 50
    x = rng.standard_normal((2, T, ci)).astype(np.float32)
    w = (rng.standard_normal((co, ci // g, k)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("ci,co,k,s,g", MSD_LAYERS)
def test_bf16_reference_matches_jax_pallas_on_bf16_operands(ci, co, k, s, g):
    """grouped_conv1d_bf16_reference against the TPU kernel's function in
    interpret mode handed bf16 x and w (its dots at the input dtype, fp32
    accumulation and output)."""
    x, w = _gc_inputs(ci, co, k, g, seed=ci + co + 2)
    pad = (k - 1) // 2
    want = np.asarray(pallas_grouped_conv1d(jnp.asarray(x).astype(jnp.bfloat16),
                                            jnp.asarray(w).astype(jnp.bfloat16), stride=s,
                                            padding=(pad, pad), groups=g, interpret=True))
    got = grouped_conv1d_bf16_reference(torch.from_numpy(x), torch.from_numpy(w), stride=s,
                                        padding=(pad, pad), groups=g)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=GC_RTOL)


def test_cpu_route_under_default_is_the_bf16_reference_and_launches_nothing():
    """On a CPU tensor under "default" the wrapper's forward is the bf16
    plain version, exactly; dx and dw are the backward convs of the rounded
    operands (the incoming gradient rounded too)."""
    ci, co, k, s, g = MSD_LAYERS[1]                 # cig 8: the padded reduction
    x, w = (torch.from_numpy(a) for a in _gc_inputs(ci, co, k, g, seed=5))
    kernel = GroupConvKernel()
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    with training_scope("default", CPU):
        y = kernel(xg, wg, stride=s, padding=(20, 20), groups=g)
    torch.testing.assert_close(y, grouped_conv1d_bf16_reference(x, w, stride=s, padding=(20, 20),
                                                                groups=g), rtol=0, atol=0)
    assert kernel.launches == kernel.launches_bf16 == 0
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    dx, dw = torch.autograd.grad(y, (xg, wg), gy)
    xr, wr = _r(x).requires_grad_(True), _r(w).requires_grad_(True)
    want = torch.autograd.grad(grouped_conv1d_reference(xr, wr, stride=s, padding=(20, 20),
                                                        groups=g), (xr, wr), _r(gy))
    torch.testing.assert_close(dx, want[0], rtol=RTOL, atol=1e-5)
    torch.testing.assert_close(dw, want[1], rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("cig", [8, 16, 24, 64])
def test_kernel_weights_bf16_layout_rebuilds_the_conv(cig):
    """[Co, K·cigp] bf16 (cigp: cig rounded up to 16 with zero channels): the
    grouped conv summed over that layout, with x rounded and channel-padded
    as the kernel stages it, in float64, equals the bf16 plain version to
    fp32's sum-order error."""
    G, cog, K, s, pad = 4, 16, 5, 2, 2
    rng = np.random.default_rng(cig)
    x = _randn(rng, 2, 23, G * cig)
    w = _randn(rng, G * cog, cig, K, scale=0.2)
    wq = kernel_weights_bf16(w)
    cigp = -(-cig // 16) * 16
    assert wq.dtype == torch.bfloat16 and wq.shape == (G * cog, K * cigp)
    assert wq.is_contiguous()
    xp = F.pad(_r(x).double(), (0, 0, pad, pad)).reshape(2, -1, G, cig)
    xp = F.pad(xp, (0, cigp - cig))                                   # [B, Tp, G, cigp]
    win = xp.unfold(1, K, s).permute(0, 1, 2, 4, 3)                   # [B, T_out, G, K, cigp]
    rows = win.reshape(*win.shape[:3], K * cigp)                      # r = j·cigp + ci
    y = torch.einsum("btgr,gcr->btgc", rows, wq.double().reshape(G, cog, K * cigp))
    want = grouped_conv1d_bf16_reference(x, w, stride=s, padding=(pad, pad), groups=G)
    torch.testing.assert_close(y.reshape(2, -1, G * cog).float(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# every task steps at every rung on the CPU
# ---------------------------------------------------------------------------

def _emformer_hp():
    return {"emformer_input_dim": 16, "emformer_layers": 2, "chunk_size": 80,
            "right_context": 2, "emformer_output_dim": 10, "lr": 1e-3, "warmup_steps": 2,
            "warmup_init_lr": 1e-4}


def _task_and_batch(kind: str, rung: str):
    rng = np.random.default_rng(3)
    if kind == "vocoder":
        task = VocoderTask(dict(VOC_HP, train_precision=rung), device="cpu")
        batch = {"mels": rng.standard_normal((2, 8, 80)).astype(np.float32),
                 "wavs": (rng.standard_normal((2, 8 * 320)) * 0.1).astype(np.float32)}
    elif kind == "conan":
        task = ConanTask(dict(CONAN_HP, vq_start=1, forcing=3, disc_start_steps=0,
                              train_precision=rung), device="cpu")
        batch = {"content": rng.integers(0, 100, (2, 64)),
                 "mels": (rng.standard_normal((2, 64, 80)) * 0.5).astype(np.float32),
                 "f0": (rng.standard_normal((2, 64)) * 0.5 + 7.5).astype(np.float32),
                 "uv": (rng.random((2, 64)) < 0.25).astype(np.float32)}
    else:
        task = EmformerTask(dict(_emformer_hp(), train_precision=rung), device="cpu")
        batch = {"mels": rng.standard_normal((2, 26, 16)).astype(np.float32),
                 "content": rng.integers(0, 10, (2, 24))}
    return task, batch


@pytest.mark.parametrize("kind", ["vocoder", "conan", "emformer"])
def test_each_task_steps_at_each_rung(kind):
    """One step of each task from the same state and batch at every rung:
    finite, not skipped; "high" equals "highest" exactly on the CPU (no
    TF32 there); "default" moves every loss by under 1% and the parameters
    by some amount. Left out of the 1%: the vocoder's STFT log-magnitude
    loss ("mag", and "total_g", which sums it), whose framed DFT takes bf16
    operands as JAX's does under DEFAULT: at random init most bins sit near
    its 1e-7 floor, where the DFT's rounding moves their log by tens of
    percent (27% on this batch)."""
    LOG_SPECTRAL = {"mag", "total_g"} if kind == "vocoder" else set()
    out = {}
    for rung in TRAINING_RUNGS:
        task, batch = _task_and_batch(kind, rung)
        assert task.precision == rung
        state = task.init_state(torch.Generator().manual_seed(0))
        new, metrics = task.train_step(state, batch)
        assert float(metrics["skipped"]) == 0.0, rung
        assert all(np.isfinite(float(v)) for v in metrics.values()), rung
        out[rung] = (new, metrics)
    key = {"vocoder": "params_g", "conan": "params_g", "emformer": "params"}[kind]
    for a, b in zip(tree_leaves(out["high"][0][key]), tree_leaves(out["highest"][0][key])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for name, v in out["highest"][1].items():
        assert float(out["high"][1][name]) == float(v), name
        rel = abs(float(out["default"][1][name]) - float(v)) / max(abs(float(v)), 1e-3)
        if name not in LOG_SPECTRAL:
            assert rel < 1e-2, (name, float(out["default"][1][name]), float(v))
    moved = [float((a - b).abs().max()) for a, b in zip(tree_leaves(out["default"][0][key]),
                                                        tree_leaves(out["highest"][0][key]))]
    assert max(moved) > 0.0
