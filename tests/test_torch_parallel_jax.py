"""The port's 2-rank step (two gloo ranks, ``tests/torch_dist_worker.py``
in its ``fixed`` mode) against the JAX package's ``shard_train_step`` over a
2-device CPU mesh (conftest gives JAX 8 virtual CPU devices), for each of
the four tasks, on the same parameters and global batches.

The random parts are fixed on both sides as tests/test_torch_*_train.py fix
them: the port's steps run without a generator (dropout off, every crop at
frame 0); JAX's mel and spectrogram discriminators are wrapped on this
test's task instances to crop at frame 0 without dropout and its Conan
model to run without dropout (``torch_port_util.jax_conan_step_fns``); the
postnet's flow step and noise are JAX's draws, handed to the port's ranks
(each cuts its rows). The cases and batches are the worker's: the vocoder
of tests/test_torch_vocoder_train.py at its 8 frames (B = 2, the MPD's
first period and the MSD's first two scales on both sides; JAX's whole
step with the spectrogram discriminator and feature matching takes minutes
to compile on the CPU, and the ranks hold those options to the one-rank step
in tests/test_torch_parallel.py), Conan from its k-means hook (tried on rows
too few first, then bootstrapping, JAX's hook on the global batch) through a
step with the VQ and the discriminator on (B = 4), the postnet (B = 4) and
the Emformer (B = 3, which both sides pad to rows [0, 1, 2, 0]). One step
each, as those files hold one: after a step whose Adam updates differ by
rounding (below), a later step's small losses (the discriminator's on the
generated mel) move by far more than 1e-4.

Tolerances, those of tests/test_torch_{vocoder,conan}_train.py (fp32 on
both sides, sums in other orders): losses rtol 1e-4; the VQ state atol/rtol
1e-4; the parameters against JAX's whole step by the relative L2 error of
each tree's update (new - old), 2e-2 (a first Adam update is ±lr wherever
|g| >> eps, so an entry whose gradient is within rounding of zero can move
by 2·lr on one side only).
"""

import functools
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conan_tpu.parallel import make_mesh, replicate, shard_batch, shard_train_step
from conan_tpu.train.tasks import ConanTask as JConanTask
from conan_tpu.train.tasks import EmformerTask as JEmformerTask
from conan_tpu.train.tasks import PostnetTask as JPostnetTask
from conan_tpu.train.tasks import VocoderTask as JVocoderTask

from tests import torch_dist_worker as W
from tests.torch_port_util import jax_conan_step_fns, numpy_params

CASES = ("vocoder_plain", "conan_fixed", "postnet", "emformer")
KEY = jax.random.PRNGKey(12)


def _jax_cases() -> tuple[dict, dict]:
    """(the worker's inputs per case, JAX's task and initial state per case)."""
    inputs, jax_side = {}, {}
    jv = W.fewer_discriminators(JVocoderTask(W.VOC_PLAIN))     # as the worker's
    pg = numpy_params(jv.gen.init, 1)
    pd = numpy_params(lambda k: {"mpd": jv.mpd.init(k), "msd": jv.msd.init(k)}, 2)
    inputs["vocoder_plain"] = {"state": {"params_g": pg, "params_d": pd}}
    jax_side["vocoder_plain"] = (jv, {"params_g": pg, "params_d": pd, "opt_g": jv.opt_g.init(pg),
                                "opt_d": jv.opt_d.init(pd), "step": jnp.zeros((), jnp.int32)})

    jc = JConanTask(W.CONAN_FIXED)
    jax_conan_step_fns(jc)             # dropout off, crops at frame 0, on this instance
    pg = numpy_params(jc.model.init, 1)
    pd = numpy_params(jc.mel_disc.init, 2)
    vq = jax.tree.map(np.asarray, jc.model.init_vq_state(jax.random.PRNGKey(3)))
    inputs["conan_fixed"] = {"state": {"params_g": pg, "params_d": pd, "vq_state": vq}}
    jax_side["conan_fixed"] = (jc, {"params_g": pg, "params_d": pd, "vq_state": vq,
                              "opt_g": jc.opt_g.init(pg), "opt_d": jc.opt_d.init(pd),
                              "step": jnp.zeros((), jnp.int32)})

    frozen_pg = numpy_params(JConanTask(dict(W.POST, f0_gen="orig")).model.init, 1)
    frozen_vq = W.frozen_conan()[1]
    jp = JPostnetTask(W.POST, frozen_pg, frozen_vq)
    p = numpy_params(jp.postnet.init, 4)
    ra, rb = jax.random.split(jax.random.split(KEY)[1])
    t = np.asarray(jax.random.randint(ra, (W.POST_B,), 0, 1000))
    x0 = np.asarray(jax.random.normal(jax.random.split(rb)[0], (W.POST_B, W.POST_T, 80)))
    inputs["postnet"] = {"state": {"params": p}, "frozen": (frozen_pg, frozen_vq),
                         "draws": (t, x0)}
    jax_side["postnet"] = (jp, {"params": p, "opt": jp.opt.init(p),
                                "step": jnp.zeros((), jnp.int32),
                                "frozen": {"conan": frozen_pg, "vq": frozen_vq}})

    je = JEmformerTask(W.EMF)
    p = numpy_params(je.model.init, 1)
    inputs["emformer"] = {"state": {"params": p}, "n_steps": 1}
    jax_side["emformer"] = (je, {"params": p, "opt": je.opt.init(p),
                                 "step": jnp.zeros((), jnp.int32)})
    return inputs, jax_side


def _jax_run(name: str, jtask, state: dict, mesh) -> dict:
    """JAX's trainer loop over the case's first global batch: the hook on the
    global batch (the probe rows first at the hook's first step, as the
    worker tries them), then the step jitted over the mesh."""
    step_fn = jtask.train_step
    if name == "conan_fixed":
        step_fn = functools.partial(jtask.train_step, use_random_ref=False)
    step = shard_train_step(step_fn, mesh)
    metrics, hook_done = [], not hasattr(jtask, "host_hook")
    for batch in W.case_batches(name)[:1]:
        if not hook_done and int(state["step"]) >= jtask.hp["vq_start"] + 1:
            for hb in (W.conan_batch(9, W.CONAN_PROBE), batch):
                new, hook_done = jtask.host_hook(state, int(state["step"]), hb)
                state = new if new is not None else state
        state, m = step(state, shard_batch(batch, mesh), replicate(KEY, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": jax.tree.map(np.asarray, state)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_jax"))
    inputs, jax_side = _jax_cases()
    with open(os.path.join(out, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    handle = W.start_ranks(out, "fixed")        # the port's ranks run while JAX compiles
    mesh = make_mesh(2)
    want = {}
    for name in CASES:
        t0 = time.perf_counter()
        want[name] = _jax_run(name, *jax_side[name], mesh)
        print(f"{name}: JAX's sharded steps {time.perf_counter() - t0:.1f} s")
    r0, r1 = W.collect(handle, timeout=300)
    return r0, r1, want, inputs


def _by_path(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {p: v for k, x in tree.items() for p, v in _by_path(x, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _by_path(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", CASES)
def test_two_rank_step_matches_jax_mesh(runs, name):
    r0, r1, want, inputs = runs
    got = r0[name]
    assert len(got["metrics"]) == len(want[name]["metrics"])
    for m, mw in zip(got["metrics"], want[name]["metrics"]):
        common = set(m) & set(mw)
        assert len(common) >= len(m) - 1, (sorted(m), sorted(mw))
        for k in common:
            np.testing.assert_allclose(m[k], mw[k], rtol=1e-4, atol=1e-7, err_msg=f"{name} {k}")
    for tree in ("params_g", "params_d", "params"):
        if tree not in inputs[name]["state"]:
            continue
        old = _by_path(inputs[name]["state"][tree])
        new_j = _by_path(want[name]["state"][tree])
        prefix = f"/{tree}"
        new_p = {p[len(prefix):]: v for p, v in got["state"].items() if p.startswith(prefix + "/")}
        assert set(new_p) == set(old) == set(new_j)
        flat = lambda d: np.concatenate([np.ravel(d[p]) for p in sorted(old)])  # noqa: E731
        assert _rel_l2(flat(new_p) - flat(old), flat(new_j) - flat(old)) < 2e-2, (name, tree)
        assert all(got["hash"][prefix + p] == r1[name]["hash"][prefix + p] for p in old)
    if name == "conan_fixed":
        vq_j = _by_path(want[name]["state"]["vq_state"])
        for p, w in vq_j.items():
            np.testing.assert_allclose(got["state"]["/vq_state" + p], w, rtol=1e-4, atol=1e-4,
                                       err_msg=p)
        assert float(vq_j["/initialized"]) == 1.0
