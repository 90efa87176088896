"""The port's vocoder families against the JAX package's, on the CPU: the
causal generator's transposed-conv upsampler ("nn") and resblock "2", the
non-causal generator, the NSF generator and its sine source, and the
vocoder registry.

Sizes: width 32 (channels 32 → 2), 8 mel frames of 80 bins, B = 2; the NSF
generator at the rates it ships with ([8, 8, 2, 2], total 256: its source
injection needs whole multiples). Parameters come from ``jax.eval_shape``
of the JAX inits with numpy values. Tolerances: fp32 on both sides in other
summation orders, atol 1e-4 (tests/test_torch_modules.py); a streaming step
against the port's own ``apply`` 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from conan_tpu.infer import build as jbuild
from conan_tpu.models.vocoder.hifigan import HifiGanConfig as JConfig
from conan_tpu.models.vocoder.hifigan import HifiGanGenerator as JHifiGan
from conan_tpu.models.vocoder.hifigan_noncausal import NonCausalHifiGanGenerator as JNonCausal
from conan_tpu.models.vocoder.hifigan_nsf import NsfHifiGanGenerator as JNsf

from conan_tpu_torch.checkpoint import params_from_jax, tree_map
from conan_tpu_torch.infer import build as pbuild
from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig, HifiGanGenerator
from conan_tpu_torch.models.vocoder.hifigan_noncausal import NonCausalHifiGanGenerator
from conan_tpu_torch.models.vocoder.hifigan_nsf import NsfHifiGanGenerator, sine_gen

from tests.test_torch_engine import _small_hparams
from tests.torch_port_util import leaf_shapes, numpy_params
from tests.torch_port_util import one_torch_thread  # noqa: F401

B, FRAMES = 2, 8
JCFG = JConfig(upsample_initial_channel=32)
NSF_RATES = dict(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _shapes(tree) -> dict:
    """leaf_shapes of a port tree whose int leaves (the NSF's strides) are
    plain ints."""
    return leaf_shapes(tree_map(np.asarray, tree))


def _port_cfg(jcfg):
    return HifiGanConfig(**dataclasses.asdict(jcfg))


def _mel(seed: int = 6, frames: int = FRAMES):
    return np.random.default_rng(seed).standard_normal((B, frames, 80)).astype(np.float32)


@pytest.mark.parametrize("upsample,resblock", [("nn", "1"), ("nn", "2"), ("shuffle", "2"),
                                               ("zero", "2")])
def test_causal_variants_match_jax(upsample, resblock):
    """``apply`` equals JAX's; where the variant streams (resblock "2" with
    "shuffle" or "zero"), ``step`` chunk by chunk equals JAX's step and the
    port's own ``apply``, its carries JAX's."""
    jcfg = dataclasses.replace(JCFG, upsample=upsample, resblock=resblock)
    jm, pm = JHifiGan(jcfg), HifiGanGenerator(_port_cfg(jcfg))
    p_np = numpy_params(jm.init, seed=5)
    p = params_from_jax(p_np, "cpu")
    assert leaf_shapes(pm.init(torch.Generator().manual_seed(0))) == leaf_shapes(p_np)
    mel = _mel()
    got = pm.apply(p, _t(mel))
    assert tuple(got.shape) == (B, FRAMES * 320, 1)
    _close(got, jax.jit(jm.apply)(p_np, mel))
    if upsample == "nn":
        return
    jstep = jax.jit(jm.step)
    jst, st = jm.init_state(B), pm.init_state(B)
    assert set(st) == set(jst)
    outs = []
    for s in range(0, FRAMES, 4):
        jy, jst = jstep(p_np, jst, mel[:, s:s + 4])
        y, st = pm.step(p, st, _t(mel[:, s:s + 4]))
        _close(y, jy)
        outs.append(y)
    for k in st:
        _close(st[k], jst[k])
    _close(torch.cat(outs, 1), got, atol=1e-5)


def test_nn_streaming_refused(tmp_path):
    """The transposed-conv upsampler is not prefix-consistent: its carries
    are refused as JAX refuses them, and the engine refuses a vocoder
    checkpoint that uses it as not streamable."""
    cfg = _port_cfg(dataclasses.replace(JCFG, upsample="nn"))
    with pytest.raises(NotImplementedError, match="prefix-consistent"):
        HifiGanGenerator(cfg).init_state(1)
    with pytest.raises(NotImplementedError):
        JHifiGan(dataclasses.replace(JCFG, upsample="nn")).init_state(1)
    assert not pbuild.streamable(HifiGanGenerator(cfg))
    assert pbuild.streamable(HifiGanGenerator(_port_cfg(JCFG)))
    hparams = _small_hparams()
    dirs = pbuild.write_random_checkpoints(str(tmp_path), hparams)
    with open(f"{dirs[2]}/config.yaml", "w") as f:
        yaml.safe_dump(dict(hparams["vocoder"], upsample="nn"), f)
    with pytest.raises(NotImplementedError, match="not streamable"):
        pbuild.build_engine(*dirs, device="cpu")
    with open(f"{dirs[2]}/config.yaml", "w") as f:
        yaml.safe_dump(hparams["vocoder"], f)
    assert pbuild.build_engine(*dirs, device="cpu").cfg.vocoder.upsample == "shuffle"
    for name in ("HifiGAN_noncausal", "HifiGAN_NSF"):
        with open(f"{dirs[0]}/config.yaml", "w") as f:
            yaml.safe_dump(dict(hparams["conan"], vocoder=name), f)
        with pytest.raises(NotImplementedError, match="not streamable"):
            pbuild.build_engine(*dirs, device="cpu")


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_noncausal_apply_matches_jax(resblock):
    jcfg = dataclasses.replace(JCFG, resblock=resblock)
    jm, pm = JNonCausal(jcfg), NonCausalHifiGanGenerator(_port_cfg(jcfg))
    p_np = numpy_params(jm.init, seed=7)
    assert leaf_shapes(pm.init(torch.Generator().manual_seed(0))) == leaf_shapes(p_np)
    mel = _mel(8)
    got = pm.apply(params_from_jax(p_np, "cpu"), _t(mel))
    want = jax.jit(jm.apply)(p_np, mel)
    # the odd kernel 10 at rate 5 pads (10 - 5) // 2 = 2 each side: 5T + 1
    assert tuple(got.shape) == want.shape == (B, ((FRAMES * 8 * 5 + 1) * 4) * 2, 1)
    _close(got, want)


def _nsf_params(jm):
    """numpy parameters for the JAX NSF tree, its noise convs' int strides
    restored (numpy_params fills non-float leaves with zeros)."""
    p = numpy_params(jm.init, seed=9)
    strides = [int(np.prod(jm.cfg.upsample_rates[i + 1:]))
               for i in range(len(jm.cfg.upsample_rates))]
    for nc, s in zip(p["noise_convs"], strides):
        nc["stride"] = s
    return p


@pytest.mark.parametrize("mode", ["f0_none", "deterministic", "jax_draws"])
def test_nsf_apply_matches_jax(mode):
    """NSF ``apply`` with no F0 (the source skipped, as ``run_test_vocoder``
    calls it), with ``deterministic=True`` (no draws), and with JAX's own
    draws (the initial phases and the noise from the key JAX's ``sine_gen``
    splits) given to the port."""
    jcfg = dataclasses.replace(JCFG, **NSF_RATES)
    jm, pm = JNsf(jcfg), NsfHifiGanGenerator(_port_cfg(jcfg))
    p_np = _nsf_params(jm)
    assert _shapes(pm.init(torch.Generator().manual_seed(0))) == leaf_shapes(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    p = params_from_jax(p_np, "cpu")
    mel = _mel(10)
    rng = np.random.default_rng(11)
    f0 = (np.abs(rng.standard_normal((B, FRAMES))) * 150 + 80).astype(np.float32)
    f0[:, 3:5] = 0.0                                    # an unvoiced span
    key = jax.random.PRNGKey(12)
    if mode == "f0_none":
        want = jm.apply(p_np, mel)
        got = pm.apply(p, _t(mel))
    elif mode == "deterministic":
        want = jm.apply(p_np, mel, jnp.asarray(f0), deterministic=True)
        got = pm.apply(p, _t(mel), _t(f0), deterministic=True)
    else:
        want = jm.apply(p_np, mel, jnp.asarray(f0), rng=key)
        r1, r2 = jax.random.split(key)
        dim = jm.HARMONIC_NUM + 1
        T = FRAMES * jcfg.total_stride
        got = pm.apply(p, _t(mel), _t(f0),
                       rand_ini=_t(jax.random.uniform(r1, (B, dim))),
                       noise_normal=_t(jax.random.normal(r2, (B, T, dim))))
    assert tuple(got.shape) == (B, FRAMES * 256, 1)
    _close(got, want)


def test_sine_gen_matches_jax():
    """The source alone, in its three modes, against JAX's; the drawn mode
    from a torch generator gives other numbers but the same voiced sines."""
    from conan_tpu.models.vocoder.hifigan_nsf import sine_gen as jsine_gen

    f0 = np.full((1, 4000, 1), 180.0, np.float32)
    f0[:, 1000:1500] = 0.0
    key = jax.random.PRNGKey(3)
    r1, r2 = jax.random.split(key)
    for kw, draws in (({"deterministic": True}, {}),
                      ({}, {"rand_ini": jax.random.uniform(r1, (1, 9)),
                            "noise_normal": jax.random.normal(r2, (1, 4000, 9))})):
        want = jsine_gen(jnp.asarray(f0), key, sample_rate=16000, **kw)
        got = sine_gen(_t(f0), sample_rate=16000, **kw,
                       **{k: _t(v) for k, v in draws.items()})
        for g, w in zip(got, want):
            _close(g, w, atol=2e-5)
    waves, uv, noise = sine_gen(_t(f0), torch.Generator().manual_seed(0), sample_rate=16000)
    assert float(uv.sum()) == 3500 and float(noise[:, 1000:1500].abs().max()) > 0.0


def test_registry_names_match_jax():
    """The three names, each building the JAX package's parameter tree."""
    assert set(pbuild.VOCODER_REGISTRY) == set(jbuild.VOCODER_REGISTRY) == {
        "HifiGAN", "HifiGAN_noncausal", "HifiGAN_NSF"}
    key = jax.random.PRNGKey(0)
    for name in pbuild.VOCODER_REGISTRY:
        jcfg = dataclasses.replace(JCFG, **NSF_RATES) if name == "HifiGAN_NSF" else JCFG
        pm = pbuild.get_vocoder_cls(name)(_port_cfg(jcfg))
        jm = jbuild.get_vocoder_cls(name)(jcfg)
        assert type(pm).__name__ == type(jm).__name__
        assert _shapes(pm.init(torch.Generator().manual_seed(0))) == leaf_shapes(
            jax.eval_shape(jm.init, key))
