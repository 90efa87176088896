"""The port's rectified-flow F0 path against the JAX package's, on the same
numpy weights, inputs and initial noise: the denoiser and both samplers,
the Conan model with f0_gen="flow", and the engine (eager loop, stream_scan,
offline) fed JAX's own noise. The sizes are tests/test_streaming_engine.py's
small flow configuration: hidden 64, a 2-layer 16-channel DiffNet, K = 6.

Tolerances: single ops and the denoiser agree to 1e-5 (fp32, sums in other
orders); the flow integrates K steps and clips, so F0 in Hz (2^(6..10)) is
held to 1e-3 absolute and 1e-4 relative, as tests/test_streaming_engine.py
holds streaming F0 to offline; mel to 1e-4 and waveforms to 1e-4; content
codes exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_tpu.infer.streaming import StreamingConfig as JStreamingConfig
from conan_tpu.infer.streaming import StreamingVoiceConversion as JEngine
from conan_tpu.models.conan import flow as jflow
from conan_tpu.models.conan.model import Conan as JConan
from conan_tpu.models.conan.model import ConanConfig as JConanConfig
from conan_tpu.models.emformer import EmformerDistillModel as JEmformer
from conan_tpu.models.vocoder.hifigan import HifiGanGenerator as JHifiGan
from conan_tpu.nn.blocks import timestep_embedding as jax_timestep_embedding

from conan_tpu_torch.checkpoint import params_from_jax
from conan_tpu_torch.infer.streaming import StreamingVoiceConversion
from conan_tpu_torch.models.conan import flow as pflow
from conan_tpu_torch.models.conan.model import Conan
from conan_tpu_torch.nn.blocks import timestep_embedding

from tests.torch_port_util import SMALL, numpy_params, port_config
from tests.torch_port_util import one_torch_thread  # noqa: F401

FLOW = JStreamingConfig(
    emformer=SMALL.emformer,
    conan=JConanConfig(hidden_size=64, f0_gen="flow", f0_k_step=6, f0_residual_layers=2,
                       f0_residual_channels=16),
    vocoder=SMALL.vocoder)
PORT = port_config(FLOW)
NET = jflow.DiffNetConfig(in_dims=1, encoder_hidden=64, residual_layers=3,
                          residual_channels=16, dilation_cycle_length=2)
HOP = 320


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _net(seed=20):
    jnet = jflow.DiffNet(NET)
    p_np = numpy_params(jnet.init, seed)
    return jnet, pflow.DiffNet(pflow.DiffNetConfig(**dataclasses.asdict(NET))), p_np


def _voiced_conan_params(seed):
    """Conan parameters whose UV head calls most frames voiced (a negative
    bias on its UV logit), so that the F0 comparisons see the flow."""
    p_np = numpy_params(JConan(FLOW.conan).init, seed)
    p_np["uv_predictor"]["out"]["b"][0] = -2.0
    return p_np


def test_timestep_embedding_matches_jax():
    """The sin/cos arguments reach t = 999 radians, where fp32's spacing is
    6.1e-5: an exp one ulp apart between XLA and ATen moves sin by that much,
    so the bound is 1e-4."""
    t = np.array([0, 1, 166, 500, 999], np.int32)
    for dim in (16, 192):
        _close(timestep_embedding(_t(t), dim), jax_timestep_embedding(jnp.asarray(t), dim),
               atol=1e-4, rtol=0)


def test_diffnet_apply_matches_jax(rng):
    jnet, pnet, p_np = _net()
    x = rng.standard_normal((2, 9, 1)).astype(np.float32)
    cond = rng.standard_normal((2, 9, 64)).astype(np.float32)
    t = np.array([3, 640], np.int32)
    want = jax.jit(jnet.apply)(p_np, x, t, cond)
    got = pnet.apply(params_from_jax(p_np, "cpu"), _t(x), _t(t), _t(cond))
    _close(got, want, atol=1e-5)
    assert np.abs(np.asarray(want)).max() > 1e-2      # the zero-init head is filled


def test_euler_grid_matches_jax():
    """The port's step indices, made on the device, and its clipping
    constants are JAX's float32 arithmetic, also where a product lands near
    an integer (K = 100 of 1000, and an odd grid)."""
    for K, T in ((100, 1000), (6, 1000), (7, 333)):
        cfg = pflow.ReflowConfig(timesteps=T, k_step=K)
        i = jnp.arange(K)
        want = ((i.astype(jnp.float32) / K) * T).astype(jnp.int32)
        t_idx, one_minus, denom = pflow._euler_constants(cfg)
        np.testing.assert_array_equal(t_idx, np.asarray(want))
        flow = pflow.RectifiedFlow(pflow.DiffNet(pflow.DiffNetConfig()), cfg)
        np.testing.assert_array_equal(flow.steps(torch.device("cpu")).numpy(), t_idx)
        tq = want.astype(jnp.float32) / T
        np.testing.assert_array_equal(one_minus, np.asarray(1.0 - tq))
        np.testing.assert_array_equal(denom, np.asarray(jnp.maximum(1.0 - tq, 1e-8)))


def test_rectified_flow_sample_and_stream_match_jax(rng):
    jnet, pnet, p_np = _net(21)
    rcfg = jflow.ReflowConfig(timesteps=1000, k_step=6)
    jf = jflow.RectifiedFlow(jnet, rcfg)
    pf = pflow.RectifiedFlow(pnet, pflow.ReflowConfig(timesteps=1000, k_step=6))
    p = params_from_jax(p_np, "cpu")
    cond = rng.standard_normal((2, 12, 64)).astype(np.float32)
    x0 = rng.standard_normal((2, 12, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jf.sample)(p_np, cond, x0))
    got = pf.sample(p, _t(cond), _t(x0))
    _close(got, want, atol=1e-5)
    assert (np.abs(want) >= 1.0).any() or np.abs(want - x0).max() > 1e-2
    x1 = rng.standard_normal((2, 12, 1)).astype(np.float32)
    t = np.array([0, 731], np.int32)
    _close(pf.q_sample(_t(x1), _t(x0), _t(t)), jf.q_sample(x1, x0, t), atol=1e-6)

    js, ps = jflow.StreamingRectifiedFlow(jf), pflow.StreamingRectifiedFlow(pf)
    jst, st = js.init_state(2), ps.init_state(2)
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: tuple(v.shape) for k, v in jst.items()}
    jstep = jax.jit(js.step)
    outs = []
    for s in range(0, 12, 4):
        jy, jst = jstep(p_np, jst, cond[:, s:s + 4], x0[:, s:s + 4])
        y, st = ps.step(p, st, _t(cond[:, s:s + 4]), _t(x0[:, s:s + 4]))
        _close(y, jy, atol=1e-5)
        for k in st:
            _close(st[k], jst[k], atol=1e-5)
        outs.append(y)
    _close(torch.cat(outs, 1), got, atol=1e-5)


def test_conan_flow_apply_and_stream_step_match_jax(rng):
    jm, pm = JConan(FLOW.conan), Conan(PORT.conan)
    p_np = _voiced_conan_params(22)
    vq_np = numpy_params(jm.init_vq_state, 23)
    p, vq = params_from_jax(p_np, "cpu"), params_from_jax(vq_np, "cpu")
    codes = rng.integers(0, 100, (2, 12)).astype(np.int32)
    codes[:, 3] = 57
    ref = rng.standard_normal((2, 30, 80)).astype(np.float32)
    noise = np.asarray(jm.sample_f0_noise(jax.random.PRNGKey(5), 2, 12))

    want = jax.jit(lambda p_, v_, c_, r_, n_: jm.apply(p_, c_, ref=r_, vq_state=v_, infer=True,
                                                       initial_noise=n_))(
        p_np, vq_np, codes, ref, noise)
    got = pm.apply(p, _t(codes), ref=_t(ref), vq_state=vq, initial_noise=_t(noise))
    f0 = np.asarray(want["f0_denorm_pred"])
    assert (f0 > 0).mean() > 0.5                      # the comparison sees the flow
    _close(got["f0_denorm_pred"], f0, atol=1e-3)
    _close(got["mel_out"], want["mel_out"])

    ctx = pm.prepare_style(p, vq, _t(ref))
    jctx = jax.jit(jm.prepare_style)(p_np, vq_np, ref)
    st, jst = pm.init_stream_state(2), jm.init_stream_state(2)
    assert set(st) == set(jst) and set(st["f0_flow"]) == set(jst["f0_flow"])
    jstep = jax.jit(jm.stream_step)
    f0s, mels = [], []
    for s in range(0, 12, 4):
        jr, jst = jstep(p_np, jst, codes[:, s:s + 4], jctx, noise[:, s:s + 4])
        r, st = pm.stream_step(p, st, _t(codes[:, s:s + 4]), ctx, _t(noise[:, s:s + 4]))
        _close(r["f0_denorm_pred"], jr["f0_denorm_pred"], atol=1e-3)
        _close(r["mel_out"], jr["mel_out"])
        f0s.append(r["f0_denorm_pred"])
        mels.append(r["mel_out"])
    # within the port, streaming ≡ offline
    _close(torch.cat(f0s, 1), got["f0_denorm_pred"], atol=1e-3)
    _close(torch.cat(mels, 1), got["mel_out"], atol=1e-5)


def _flow_engines(seed=30):
    jm = JConan(FLOW.conan)
    trees = (numpy_params(JEmformer(FLOW.emformer).init, seed), _voiced_conan_params(seed + 1),
             numpy_params(jm.init_vq_state, seed + 2),
             numpy_params(JHifiGan(FLOW.vocoder).init, seed + 3))
    port = StreamingVoiceConversion(PORT, *[params_from_jax(t, "cpu") for t in trees],
                                    device="cpu")
    return JEngine(FLOW, *trees), port


def test_flow_engine_matches_jax_fed_its_noise(rng):
    """The port's engine, fed JAX's sample_f0_noise through f0_noise, equals
    JAX's infer_once from the same key: eager loop, stream_scan and offline."""
    jeng, eng = _flow_engines()
    src = (rng.standard_normal(HOP * 14) * 0.1).astype(np.float32)
    ref = (rng.standard_normal(HOP * 20) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want, want_codes = jeng.infer_once(src, ref, collect_codes=True, rng=key)
    T_pad = -(-(len(src) // HOP + 1) // 4) * 4
    noise = np.asarray(jeng.conan.sample_f0_noise(key, 1, T_pad))
    for name, (wav, codes) in {
            "eager": eng.infer_once(src, ref, collect_codes=True, f0_noise=noise),
            "scan": eng.infer_once(src, ref, collect_codes=True, use_scan=True,
                                   f0_noise=noise),
            "offline": eng.infer_offline(src, ref, collect_codes=True, f0_noise=noise)}.items():
        np.testing.assert_array_equal(codes, want_codes, err_msg=name)
        np.testing.assert_allclose(wav, want, atol=1e-4, err_msg=name)


def test_flow_engine_generator_streams_as_offline(rng):
    """One generator seed draws one noise: the eager loop, stream_scan and
    offline agree; bucketed scan agrees with bucketed offline (both draw at
    the bucketed length); another seed gives another F0 trajectory."""
    _, eng = _flow_engines(40)
    src = (rng.standard_normal(HOP * 13) * 0.1).astype(np.float32)
    ref = (rng.standard_normal(HOP * 11) * 0.1).astype(np.float32)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    wav, codes = eng.infer_once(src, ref, collect_codes=True, generator=gen(9))
    for other in (eng.infer_once(src, ref, collect_codes=True, use_scan=True,
                                 generator=gen(9)),
                  eng.infer_offline(src, ref, collect_codes=True, generator=gen(9))):
        np.testing.assert_array_equal(other[1], codes)
        np.testing.assert_allclose(other[0], wav, atol=1e-4)
    b_scan = eng.infer_once(src, ref, collect_codes=True, use_scan=True, bucket_lengths=True,
                            generator=gen(9))
    b_off = eng.infer_offline(src, ref, collect_codes=True, bucket_lengths=True,
                              generator=gen(9))
    np.testing.assert_array_equal(b_scan[1], b_off[1])
    np.testing.assert_allclose(b_scan[0], b_off[0], atol=1e-4)
    # the default generator is seeded 0
    np.testing.assert_array_equal(eng.infer_once(src, ref),
                                  eng.infer_once(src, ref, generator=gen(0)))
    # F0 level: another seed moves the trajectory
    with torch.inference_mode():
        mel_ext, _, T_pad = eng._source_chunks(eng.wav_to_mel(src))
        codes_t = torch.argmax(eng.emformer.apply(eng.p_emformer, mel_ext), -1)
        style = eng._prepare(eng.wav_to_mel(ref))
        f0 = [eng.conan.decode(eng.p_conan, codes_t, style,
                               eng.conan.sample_f0_noise(gen(s), 1, T_pad))["f0_denorm_pred"]
              for s in (9, 10)]
    voiced = f0[0] > 0
    assert voiced.float().mean() > 0.5
    assert (f0[0] - f0[1]).abs().max() > 1.0


def test_stream_step_without_noise_uses_zeros():
    pm = Conan(PORT.conan)
    p = params_from_jax(_voiced_conan_params(50), "cpu")
    vq = params_from_jax(numpy_params(JConan(FLOW.conan).init_vq_state, 51), "cpu")
    codes = torch.randint(0, 100, (1, 4), generator=torch.Generator().manual_seed(0))
    ctx = pm.prepare_style(p, vq, torch.randn(1, 16, 80, generator=torch.Generator()))
    a, _ = pm.stream_step(p, pm.init_stream_state(1), codes, ctx)
    b, _ = pm.stream_step(p, pm.init_stream_state(1), codes, ctx, torch.zeros(1, 4, 1))
    torch.testing.assert_close(a["f0_denorm_pred"], b["f0_denorm_pred"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="initial_noise"):
        pm.decode(p, codes, ctx)
