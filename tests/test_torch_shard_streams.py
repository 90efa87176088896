"""``StreamingVoiceConversion.shard_streams``: B streams data-parallel over
devices (here two CPU "devices"), against the unsharded port and the JAX
package's ``shard_streams`` over a 2-device mesh, at the small engine of
tests/torch_port_util.py (and tests/test_torch_flow.py's flow F0 engine).

Tolerances: the sharded port against the unsharded port, atol 1e-5 (the
bound tests/test_streaming_engine.py holds JAX's sharded engine to its
unsharded one with); against JAX, codes equal and the wav at atol 1e-5 as
well.
"""

import jax
import numpy as np
import pytest
import torch

from conan_tpu.infer.streaming import StreamingVoiceConversion as JEngine
from conan_tpu.parallel import make_mesh

from conan_tpu_torch.checkpoint import params_from_jax
from conan_tpu_torch.infer.streaming import StreamingVoiceConversion

from tests.test_torch_engine import _small_params
from tests.test_torch_flow import FLOW, PORT, _flow_engines
from tests.torch_port_util import SMALL, port_config
from tests.torch_port_util import one_torch_thread  # noqa: F401

HOP = 320
B = 4


def _wavs(rng, n_src: int = 14, n_ref: int = 20):
    src = (rng.standard_normal((B, HOP * n_src)) * 0.1).astype(np.float32)
    ref = (rng.standard_normal((B, HOP * n_ref)) * 0.1).astype(np.float32)
    return src, ref


def test_sharded_streams_equal_unsharded_and_jax(rng):
    trees = _small_params()
    eng = StreamingVoiceConversion(port_config(SMALL), *[params_from_jax(t, "cpu")
                                                         for t in trees], device="cpu")
    src, ref = _wavs(rng)
    plain = {"eager": eng.infer_once(src, ref, collect_codes=True),
             "scan": eng.infer_once(src, ref, collect_codes=True, use_scan=True),
             "offline": eng.infer_offline(src, ref, collect_codes=True)}
    eng.shard_streams(["cpu", "cpu"])
    assert len(eng._shards) == 2 and all(s.device.type == "cpu" for s in eng._shards)
    sharded = {"eager": eng.infer_once(src, ref, collect_codes=True),
               "scan": eng.infer_once(src, ref, collect_codes=True, use_scan=True),
               "offline": eng.infer_offline(src, ref, collect_codes=True)}
    for name, (wav, codes) in sharded.items():
        assert wav.shape == plain[name][0].shape == (B, (HOP * 14 // HOP + 1) * HOP)
        np.testing.assert_array_equal(codes, plain[name][1], err_msg=name)
        np.testing.assert_allclose(wav, plain[name][0], atol=1e-5, err_msg=name)
    jeng = JEngine(SMALL, *trees)
    jeng.shard_streams(make_mesh(2))
    jwav, jcodes = jeng.infer_once(src, ref, collect_codes=True)
    np.testing.assert_array_equal(sharded["eager"][1], jcodes)
    np.testing.assert_allclose(sharded["eager"][0], jwav, atol=1e-5)


def test_sharded_flow_streams_draw_their_noise_before_the_split(rng):
    """f0_gen="flow": a generator's noise is drawn for the whole batch and
    then split, so the sharded output is the unsharded one for the same
    seed; fed JAX's noise, it is JAX's sharded engine's output."""
    jeng, eng = _flow_engines()
    src, ref = _wavs(rng)
    plain = eng.infer_once(src, ref, collect_codes=True, generator=torch.Generator().manual_seed(5))
    eng.shard_streams(["cpu", "cpu"])
    got = eng.infer_once(src, ref, collect_codes=True, generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(got[1], plain[1])
    np.testing.assert_allclose(got[0], plain[0], atol=1e-5)
    off = eng.infer_offline(src, ref, collect_codes=True,
                            generator=torch.Generator().manual_seed(5))
    np.testing.assert_allclose(off[0], got[0], atol=1e-4)      # streaming ≡ offline bound
    key = jax.random.PRNGKey(3)
    T_pad = -(-(HOP * 14 // HOP + 1) // FLOW.emformer.segment_length) * FLOW.emformer.segment_length
    noise = np.asarray(jeng.conan.sample_f0_noise(key, B, T_pad))
    jeng.shard_streams(make_mesh(2))
    jwav, jcodes = jeng.infer_once(src, ref, collect_codes=True, rng=key)
    wav, codes = eng.infer_once(src, ref, collect_codes=True, f0_noise=noise)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_allclose(wav, jwav, atol=1e-5)
    assert PORT.conan.f0_gen == "flow"


def test_streams_not_a_multiple_of_the_shards_raise(rng):
    trees = _small_params()
    eng = StreamingVoiceConversion(port_config(SMALL), *[params_from_jax(t, "cpu")
                                                         for t in trees], device="cpu")
    eng.shard_streams(["cpu", "cpu"])
    src, ref = _wavs(rng, 6, 8)
    for call in (eng.infer_once, eng.infer_offline):
        with pytest.raises(ValueError, match="multiple of the shards"):
            call(src[:3], ref[:3])
