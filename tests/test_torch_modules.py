"""Each module of the PyTorch port against its JAX counterpart on the same
parameters and inputs (made from seeds with numpy), and each streaming module
step ≡ offline within the port.

Tolerances: both packages compute in fp32 on the CPU, in other summation
orders (XLA's conv and dot lowering against ATen's; the Emformer's banded
attention in JAX against the port's dense masked form), so values agree to
atol 1e-4 (1e-5 for single ops). Discrete outputs (Emformer codes) must be
equal. Within the port, streaming and offline run the same ops on the same
rows, so they agree to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_tpu import ops as jops
from conan_tpu.ops.conv import fold_weight_norm as jax_fold_weight_norm
from conan_tpu.models.conan.model import Conan as JConan
from conan_tpu.models.emformer import EmformerDistillModel as JEmformer
from conan_tpu.models.vocoder.hifigan import HifiGanGenerator as JHifiGan

from conan_tpu_torch import ops as pops
from conan_tpu_torch.checkpoint import params_from_jax
from conan_tpu_torch.models.conan.model import Conan, ConanConfig
from conan_tpu_torch.models.emformer import EmformerDistillModel
from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig, HifiGanGenerator
from conan_tpu_torch.nn.module import Stream

from tests.torch_port_util import SMALL, leaf_shapes, numpy_params, port_config
from tests.torch_port_util import one_torch_thread  # noqa: F401

PORT = port_config(SMALL)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# conv ops and the Stream carry
# ---------------------------------------------------------------------------

def test_conv_ops_match_jax(rng):
    x = rng.standard_normal((2, 13, 6)).astype(np.float32)
    w = (rng.standard_normal((5, 6, 3)) * 0.3).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    _close(pops.conv1d(_t(x), _t(w), _t(b), dilation=2, padding=(3, 1)),
           jops.conv1d(x, w, b, dilation=2, padding=(3, 1)), atol=1e-5)
    _close(pops.causal_conv1d(_t(x), _t(w), _t(b), dilation=3),
           jops.causal_conv1d(x, w, b, dilation=3), atol=1e-5)
    y = rng.standard_normal((2, 5, 12)).astype(np.float32)
    np.testing.assert_array_equal(pops.pixel_shuffle_1d(_t(y), 4).numpy(),
                                  np.asarray(jops.pixel_shuffle_1d(y, 4)))
    p = {"v": w, "g": np.abs(rng.standard_normal((5, 1, 1))).astype(np.float32), "b": b}
    _close(pops.weight_norm_weight(params_from_jax(p, "cpu")), jops.weight_norm_weight(p),
           atol=1e-6)
    folded = pops.fold_weight_norm({"a": [params_from_jax(p, "cpu")]})
    assert set(folded["a"][0]) == {"w", "b"}
    _close(folded["a"][0]["w"], jax_fold_weight_norm({"a": [p]})["a"][0]["w"], atol=1e-6)


@pytest.mark.parametrize("dilation", [1, 3])
def test_causal_step_equals_offline_and_jax_carry(rng, dilation):
    x = rng.standard_normal((2, 12, 4)).astype(np.float32)
    w = (rng.standard_normal((3, 4, 5)) * 0.3).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    full = pops.causal_conv1d(_t(x), _t(w), _t(b), dilation=dilation)
    carry = pops.causal_conv1d_state(2, 4, 5, dilation)
    jcarry = jops.causal_conv1d_state(2, 4, 5, dilation)
    outs = []
    for s in range(0, 12, 4):
        y, carry = pops.causal_conv1d_step(_t(x[:, s:s + 4]), carry, _t(w), _t(b),
                                           dilation=dilation)
        _, jcarry = jops.causal_conv1d_step(x[:, s:s + 4], jcarry, w, b, dilation=dilation)
        np.testing.assert_array_equal(carry.numpy(), np.asarray(jcarry))
        outs.append(y)
    _close(torch.cat(outs, 1), full, atol=1e-5)
    # the Stream context routes the same op by path key
    s = Stream({"c": pops.causal_conv1d_state(2, 4, 5, dilation)})
    y = s.causal_conv("c", _t(x[:, :4]), {"w": _t(w), "b": _t(b)}, dilation=dilation,
                      weight_norm=False)
    _close(y, full[:, :4], atol=1e-5)
    assert tuple(s.new_state["c"].shape) == (2, dilation * 4, 4)


# ---------------------------------------------------------------------------
# Emformer
# ---------------------------------------------------------------------------

def test_emformer_apply_step_match_jax():
    cfg = SMALL.emformer
    jm, pm = JEmformer(cfg), EmformerDistillModel(PORT.emformer)
    p_np = numpy_params(jm.init, seed=1)
    p = params_from_jax(p_np, "cpu")
    rng = np.random.default_rng(3)
    seg, rc = cfg.segment_length, cfg.right_context_length
    n_segs = 7
    mel = rng.standard_normal((2, n_segs * seg + rc, 80)).astype(np.float32)
    lengths = np.array([n_segs * seg + rc, n_segs * seg - 5], np.int32)

    want = np.asarray(jax.jit(jm.apply)(p_np, mel))
    got = pm.apply(p, _t(mel))
    _close(got, want)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    want_len = np.asarray(jax.jit(jm.apply)(p_np, mel, jnp.asarray(lengths)))
    _close(pm.apply(p, _t(mel), _t(lengths)), want_len)

    jstep = jax.jit(jm.step)
    jst, st = jm.init_state(2), pm.init_state(2)
    steps = []
    for s in range(n_segs):
        chunk = mel[:, s * seg:s * seg + seg + rc]
        jl, jst = jstep(p_np, jst, chunk)
        pl, st = pm.step(p, st, _t(chunk))
        _close(pl, jl)
        np.testing.assert_array_equal(pl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))
        steps.append(pl)
    assert set(st) == set(jst)
    for k in st:
        _close(st[k], jst[k])
    _close(torch.cat(steps, 1), got, atol=1e-5)


# ---------------------------------------------------------------------------
# Conan acoustic model
# ---------------------------------------------------------------------------

def _conan_inputs(rng, B=2, T=12, Tr=30):
    codes = rng.integers(0, 100, (B, T)).astype(np.int32)
    codes[:, 3] = 57   # silent token: forced unvoiced
    ref = rng.standard_normal((B, Tr, 80)).astype(np.float32)
    ref[1, -7:] = 0.0  # a padded reference
    return codes, ref


def test_conan_prepare_apply_stream_match_jax():
    jm, pm = JConan(SMALL.conan), Conan(PORT.conan)
    p_np = numpy_params(jm.init, seed=2)
    vq_np = numpy_params(jm.init_vq_state, seed=3)
    p, vq = params_from_jax(p_np, "cpu"), params_from_jax(vq_np, "cpu")
    codes, ref = _conan_inputs(np.random.default_rng(4))

    jctx = jax.jit(jm.prepare_style)(p_np, vq_np, ref)
    ctx = pm.prepare_style(p, vq, _t(ref))
    assert set(ctx) == set(jctx)
    for k in ctx:
        _close(ctx[k], jctx[k])

    want = jax.jit(lambda p_, v_, c_, r_: jm.apply(p_, c_, ref=r_, vq_state=v_, infer=True)
                   ["mel_out"])(p_np, vq_np, codes, ref)
    got = pm.apply(p, _t(codes), ref=_t(ref), vq_state=vq)["mel_out"]
    _close(got, want)

    st = pm.init_stream_state(2)
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: tuple(v.shape) for k, v in jm.init_stream_state(2).items()}
    chunks = []
    for s in range(0, codes.shape[1], 4):
        ret, st = pm.stream_step(p, st, _t(codes[:, s:s + 4]), ctx)
        chunks.append(ret["mel_out"])
    _close(torch.cat(chunks, 1), got, atol=1e-5)


def test_conan_prosody_positions_past_the_table_match_jax():
    """A reference longer than the positional table (max_source_positions + 2
    rows, one row per 4 reference frames) reads the table's last row, as the
    JAX package's gather clamps the index; it does not raise."""
    jcfg = dataclasses.replace(SMALL.conan, max_source_positions=3)
    jm, pm = JConan(jcfg), Conan(dataclasses.replace(PORT.conan, max_source_positions=3))
    p_np = numpy_params(jm.init, seed=2)
    vq_np = numpy_params(jm.init_vq_state, seed=3)
    _, ref = _conan_inputs(np.random.default_rng(4), Tr=40)   # 10 positions > 5 rows
    want = jax.jit(jm.prepare_style)(p_np, vq_np, ref)["prosody"]
    got = pm.prepare_style(params_from_jax(p_np, "cpu"), params_from_jax(vq_np, "cpu"),
                           _t(ref))["prosody"]
    assert tuple(got.shape) == (2, 10, 64)
    _close(got, want)


# ---------------------------------------------------------------------------
# HiFi-GAN vocoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("upsample", ["shuffle", "zero"])
def test_vocoder_apply_step_match_jax(upsample):
    jcfg = dataclasses.replace(SMALL.vocoder, upsample=upsample)
    jm = JHifiGan(jcfg)
    pm = HifiGanGenerator(dataclasses.replace(PORT.vocoder, upsample=upsample))
    p_np = numpy_params(jm.init, seed=5)
    p = params_from_jax(p_np, "cpu")
    mel = np.random.default_rng(6).standard_normal((2, 8, 80)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(p_np, mel))
    got = pm.apply(p, _t(mel))
    assert tuple(got.shape) == (2, 8 * 320, 1)
    _close(got, want)

    jstep = jax.jit(jm.step)
    jst, st = jm.init_state(2), pm.init_state(2)
    assert set(st) == set(jst)
    outs = []
    for s in range(0, 8, 4):
        jy, jst = jstep(p_np, jst, mel[:, s:s + 4])
        y, st = pm.step(p, st, _t(mel[:, s:s + 4]))
        _close(y, jy)
        outs.append(y)
    for k in st:
        _close(st[k], jst[k])
    _close(torch.cat(outs, 1), got, atol=1e-5)


def test_vocoder_variants_not_ported_raise():
    for cfg in (HifiGanConfig(upsample="nn"), HifiGanConfig(resblock="2")):
        with pytest.raises(NotImplementedError):
            HifiGanGenerator(cfg)


# ---------------------------------------------------------------------------
# the port's own init (seeded random engines) builds the JAX package's trees
# ---------------------------------------------------------------------------

def test_port_init_trees_match_jax():
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    flow = dataclasses.replace(SMALL.conan, f0_gen="flow", f0_residual_layers=3,
                               f0_residual_channels=16)
    pairs = [(EmformerDistillModel(PORT.emformer).init(gen),
              jax.eval_shape(JEmformer(SMALL.emformer).init, key)),
             (Conan(PORT.conan).init(gen), jax.eval_shape(JConan(SMALL.conan).init, key)),
             (Conan(ConanConfig(**dataclasses.asdict(flow))).init(gen),
              jax.eval_shape(JConan(flow).init, key)),
             (Conan(PORT.conan).init_vq_state(gen),
              jax.eval_shape(JConan(SMALL.conan).init_vq_state, key)),
             (HifiGanGenerator(PORT.vocoder).init(gen),
              jax.eval_shape(JHifiGan(SMALL.vocoder).init, key))]
    for port_tree, jax_tree in pairs:
        assert leaf_shapes(port_tree) == leaf_shapes(jax_tree)
