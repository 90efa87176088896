"""The vocoder GAN's and the trainers' options in the port against the JAX
package's, on the CPU: the conditional MPD and MSD, a VocoderTask step with
the conditional discriminators, the spectrogram discriminator and feature
matching on, a step of the non-causal generator, gradient accumulation
(``accumulate_grad_batches``, optax.MultiSteps) for VocoderTask and
ConanTask, EmformerTask and PostnetTask ignoring it as JAX's do, and the
Conan step with the speaker-id embedding or a pre-extracted speaker
embedding.

Sizes: tests/test_train_steps.py's VOC_HP (width 16) and CONAN_HP (hidden
32); the options step at B = 2 of 32 mel frames (10240 samples: every window
of the spectrogram discriminator, up to 32 frames, fits), the others of 8.

Randomness: the spectrogram discriminator's crops and Dropout2d are drawn
from a ``torch.Generator`` in the port; both sides run with them fixed (no
dropout, crops at frame 0: the port's step without a generator, JAX's with
its discriminator's ``apply`` wrapped inside this test).

Tolerances, as tests/test_torch_vocoder_train.py's: logits and feature maps
atol/rtol 1e-4; losses rtol 1e-4; gradients a relative L2 error of 1e-3 per
leaf and 1e-4 over each tree (over 32 frames each leaf against the port's
float64 step, see ``_check_grads``); parameters after a step atol 1e-6 against
JAX's optimizer update (MultiSteps where accumulating) and NaN guard applied
to the port's own gradients. Accumulation holds every leaf, and the
accumulator's state, after each mini-step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conan_tpu.train import optim as JO
from conan_tpu.train import tasks as jtasks
from conan_tpu.train.tasks import ConanTask as JConanTask
from conan_tpu.train.tasks import EmformerTask as JEmformerTask
from conan_tpu.train.tasks import PostnetTask as JPostnetTask
from conan_tpu.train.tasks import VocoderTask as JVocoderTask

from conan_tpu_torch.checkpoint import (load_ckpt_state, params_from_jax, save_checkpoint,
                                        tree_leaves, tree_map)
from conan_tpu_torch.train import optim as PO
from conan_tpu_torch.train.tasks import (ConanTask, EmformerTask, PostnetTask, VocoderTask,
                                         _gated_update, _grads, _with_grad)

from tests.test_train_steps import CONAN_HP, VOC_HP
from tests.torch_port_util import jax_conan_step_fns, numpy_params
from tests.torch_port_util import one_torch_thread  # noqa: F401

B, HOP = 2, 320
AUDIO = dict(fmin=80, fmax=7600)
OPTIONS_HP = dict(VOC_HP, **AUDIO, use_cond_disc=True, use_spec_disc=True, use_fm_loss=True)
# the non-causal generator pads each transposed conv by (k - u) / 2 a side:
# kernel 11 at rate 5 keeps T·320 samples, the shipped 10 would make T·320 + 8
NONCAUSAL_HP = dict(VOC_HP, generator_type="noncausal", upsample_kernel_sizes=[16, 11, 8, 4])


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _flat(leaves):
    return jnp.concatenate([jnp.ravel(jnp.asarray(x)) for x in leaves])


def _unflat(vec, like):
    leaves = jax.tree.leaves(like)
    parts = np.split(np.asarray(vec), np.cumsum([x.size for x in leaves])[:-1])
    return [p.reshape(x.shape) for p, x in zip(parts, leaves)]


def _voc_batch(seed: int, frames: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"mels": rng.standard_normal((B, frames, 80)).astype(np.float32),
            "wavs": (0.1 * rng.standard_normal((B, frames * HOP))).astype(np.float32)}


def _fix_specd(jtask) -> None:
    """JAX's spectrogram discriminator on this task instance with the random
    parts fixed as the port's step without a generator runs them."""
    apply = jtask.specd.apply
    jtask.specd.apply = lambda pd, mel, rng, train=False, start_frames=None: apply(
        pd, mel, rng, train=False, start_frames=[0] * len(jtask.specd.windows))


def _voc_params(jtask):
    pd_init = lambda k: {"mpd": jtask.mpd.init(k), "msd": jtask.msd.init(k),  # noqa: E731
                         **({"specd": jtask.specd.init(k)} if jtask.use_spec_disc else {})}
    return numpy_params(jtask.gen.init, 1), numpy_params(pd_init, 2)


# ---------------------------------------------------------------------------
# the conditional discriminators
# ---------------------------------------------------------------------------

def test_conditional_discriminators_match_jax():
    jtask, task = JVocoderTask(OPTIONS_HP), VocoderTask(OPTIONS_HP, device="cpu")
    _, pd_np = _voc_params(jtask)
    pd = params_from_jax(pd_np, "cpu")
    batch = _voc_batch(3, 8)
    y = batch["wavs"][..., None]
    y_hat = (0.5 * np.random.default_rng(4).standard_normal(y.shape)).astype(np.float32)
    for name, jd, d, to_jax_layout in (("mpd", jtask.mpd, task.mpd, (0, 2, 3, 1)),
                                       ("msd", jtask.msd, task.msd, (0, 1, 2))):
        assert all(dd.use_cond for dd in d.discs)
        want = jax.jit(jd.apply)(pd_np[name], y, y_hat, batch["mels"])
        got = d.apply(pd[name], _t(y), _t(y_hat), _t(batch["mels"]))
        for g_list, w_list in zip(got[:2], want[:2]):           # logits
            assert len(g_list) == len(w_list) == len(d.discs)
            for g, w in zip(g_list, w_list):
                _close(g, w)
        for g_disc, w_disc in zip(got[2] + got[3], want[2] + want[3]):   # feature maps
            for g, w in zip(g_disc, w_disc):
                _close(g.permute(*to_jax_layout), w)


# ---------------------------------------------------------------------------
# one VocoderTask step with the options on
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=3)
def _jax_update(grads, params, opt_state, opt):
    """JAX's optimizer update and NaN guard, as its train_step applies them."""
    upd, new_opt = opt.update(grads, opt_state, params)
    return jtasks._gated_update(jtasks._tree_finite(grads), params, upd, new_opt, opt_state)


def _port_voc_grads(task, state: dict, batch: dict):
    """The port's generator and discriminator gradients, as its train_step
    takes them, from ``state`` on ``batch``."""
    mel, y = _t(batch["mels"]), _t(batch["wavs"])
    pg = _with_grad(state["params_g"])
    gtot, _, y_ = task._gen_losses(pg, state["params_d"], mel, y)
    grads_g = torch.autograd.grad(gtot, tree_leaves(pg))
    pd = _with_grad(state["params_d"])
    dtot, _ = task._disc_losses(pd, y, y_.detach(), mel)
    return grads_g, _grads(dtot, pd)


def _check_grads(got: list, want, exact: list | None = None) -> None:
    """The port's gradient leaves against JAX's (``want``, a tree): the whole
    tree within 1e-4 (relative L2), each leaf within 1e-3. Given the port's
    float64 step (``exact``), each leaf is held to that instead: JAX's fp32
    leaf within 1e-4 of the tree's norm, and the port's fp32 leaf within
    max(1e-3, 4 × JAX's fp32 error on that leaf), relative to the leaf's own
    norm. Over 32 frames the per-leaf bound of 1e-3 holds for neither fp32
    side: leaves of 1e-6-1e-4 whose gradient is a sum of cancelling products
    (the period-2 MPD's, each 1e-7 of the tree's norm, its conditioning net
    included) land 0.6-1% from float64, the port's and JAX's alike to three
    digits, and the 1-channel weight-norm gains of the last resblocks
    0.3-0.5%."""
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    tree = _flat(want)
    assert _rel_l2(_flat([g.numpy() for g in got]), tree) < 1e-4
    norm = float(jnp.linalg.norm(tree))
    for path, g, w, e in zip(paths, got, want, exact or [None] * len(got)):
        assert g.shape == w.shape
        if e is None:
            assert _rel_l2(g, w) < 1e-3, path
            continue
        e = e.numpy()
        assert np.linalg.norm(e - np.asarray(w, np.float64)) < 1e-4 * norm, path
        assert _rel_l2(g, e) <= max(1e-3, 4 * _rel_l2(w, e)), path


@pytest.mark.parametrize("hp,frames", [(OPTIONS_HP, 32), (NONCAUSAL_HP, 8)],
                         ids=["cond_spec_fm", "noncausal"])
def test_vocoder_step_with_options_matches_jax(hp, frames):
    jtask, task = JVocoderTask(hp), VocoderTask(hp, device="cpu")
    if jtask.use_spec_disc:
        _fix_specd(jtask)
    pg_np, pd_np = _voc_params(jtask)
    batch = _voc_batch(5, frames)
    key = jax.random.PRNGKey(0)
    mel, y = jnp.asarray(batch["mels"]), jnp.asarray(batch["wavs"])
    (gtot_j, (gl_j, y_j)), grads_g_j = jax.jit(
        jax.value_and_grad(jtask._gen_losses, has_aux=True))(pg_np, pd_np, mel, y, key)
    (dtot_j, dl_j), grads_d_j = jax.jit(jax.value_and_grad(jtask._disc_losses, has_aux=True))(
        pd_np, mel, y, jax.lax.stop_gradient(y_j), key)

    state = task.init_state(torch.Generator().manual_seed(0))
    state["params_g"], state["params_d"] = (params_from_jax(pg_np, "cpu"),
                                            params_from_jax(pd_np, "cpu"))
    state["opt_g"], state["opt_d"] = (task.opt_g.init(state["params_g"]),
                                      task.opt_d.init(state["params_d"]))
    with torch.backends.mkldnn.flags(enabled=False):
        grads_g, grads_d = _port_voc_grads(task, state, batch)
        new_state, metrics = task.train_step(state, batch)
    exact = (None, None)
    if frames > 8:
        state64 = tree_map(lambda t: t.double() if t.is_floating_point() else t, state)
        with torch.backends.mkldnn.flags(enabled=False):
            exact = _port_voc_grads(task, state64, {k: v.astype(np.float64)
                                                    for k, v in batch.items()})
    for got, want, g64 in ((grads_g, grads_g_j, exact[0]), (grads_d, grads_d_j, exact[1])):
        _check_grads(got, want, g64)
    want_m = {**gl_j, **dl_j, "total_g": gtot_j, "total_d": dtot_j}
    assert set(metrics) == set(want_m) | {"skipped"} and float(metrics["skipped"]) == 0.0
    if hp is OPTIONS_HP:
        assert {"fm_f", "fm_s", "a_mel", "r_mel", "f_mel", "f_p_cd1", "f_s_cd2"} <= set(metrics)
        assert float(metrics["a_mel"]) > 0 and float(metrics["r_mel"]) > 0  # every window fit
    for k, want in want_m.items():
        _close(metrics[k], want, atol=0)
    for new, old, grads, opt in ((new_state["params_g"], pg_np, grads_g, jtask.opt_g),
                                 (new_state["params_d"], pd_np, grads_d, jtask.opt_d)):
        flat_old = _flat(jax.tree.leaves(old))
        applied = _jax_update(_flat([g.numpy() for g in grads]), flat_old,
                              opt.init(flat_old), opt)[0]
        for n, a in zip(tree_leaves(new), _unflat(applied, old)):
            _close(n, a, atol=1e-6, rtol=0)


def test_spec_disc_draws_from_the_generator():
    """With a generator the spectrogram discriminator's crops and Dropout2d
    are drawn, so the step's adversarial mel terms move with the seed; the
    windows that do not fit a batch (32 frames over 8) leave them zero."""
    task = VocoderTask(OPTIONS_HP, device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    pd = state["params_d"]
    mel = _t(_voc_batch(6, 32)["mels"])
    outs = [float(task.specd.apply(pd["specd"], mel, torch.Generator().manual_seed(s))[0].sum())
            for s in (1, 2)]
    assert outs[0] != outs[1]
    _, metrics = task.train_step(state, _voc_batch(6, 8), torch.Generator().manual_seed(1))
    assert float(metrics["a_mel"]) == float(metrics["r_mel"]) == float(metrics["f_mel"]) == 0.0


# ---------------------------------------------------------------------------
# gradient accumulation
# ---------------------------------------------------------------------------

def _inner_adam(jstate):
    return next(s for s in jstate.inner_opt_state if hasattr(s, "mu"))


def test_accumulate_matches_optax_multisteps():
    """The optimizer alone: clip → Adam → weight decay → LR inside
    MultiSteps(k = 3) against the port's Accumulate on the same gradients,
    a non-finite one among them dropped whole by the NaN guard on both
    sides; every leaf of the parameters and of the state after each
    mini-step."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]}
    sched = (2e-3, 2, 0.5)
    jopt = JO.adamw(JO.step_lr_schedule(*sched), weight_decay=0.01, clip_norm=0.5,
                    accumulate_steps=3)
    popt = PO.accumulating(PO.AdamW(PO.step_lr_schedule(*sched), weight_decay=0.01,
                                    clip_norm=0.5), 3)
    assert isinstance(popt, PO.Accumulate)
    jp, js = params, jopt.init(params)
    pp = params_from_jax(params, "cpu")
    ps = popt.init(pp)

    @jax.jit
    def jstep(g, p, s):
        upd, new = jopt.update(g, s, p)
        return jtasks._gated_update(jtasks._tree_finite(g), p, upd, new, s)

    for i in range(8):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * (i + 1)).astype(np.float32),
                         params)
        if i == 4:
            g["a"][1, 2] = np.nan
        jp, js = jstep(g, jp, js)
        gt = params_from_jax(g, "cpu")
        upd, new = popt.update(gt, ps, pp)
        ok = torch.stack([torch.isfinite(x).all() for x in tree_leaves(gt)]).all()
        pp, ps = _gated_update(ok, pp, upd, new, ps)
        for a, b in zip(tree_leaves(pp), jax.tree.leaves(jp)):
            _close(a, b, atol=1e-6, rtol=0)
        assert int(ps["mini_step"]) == int(js.mini_step)
        assert int(ps["gradient_step"]) == int(js.gradient_step)
        for a, b in zip(tree_leaves(ps["acc"]), jax.tree.leaves(js.acc_grads)):
            _close(a, b, atol=1e-6, rtol=1e-6)
        adam = _inner_adam(js)
        assert int(ps["inner"]["count"]) == int(adam.count)
        for a, b in zip(tree_leaves(ps["inner"]["mu"]) + tree_leaves(ps["inner"]["nu"]),
                        jax.tree.leaves(adam.mu) + jax.tree.leaves(adam.nu)):
            _close(a, b, atol=1e-7, rtol=1e-5)
    assert int(ps["gradient_step"]) == 2        # 7 finite mini-steps: two updates


def _resume(state: dict, tmp_path) -> dict:
    """Through a checkpoint and back, as a resumed run loads it."""
    save_checkpoint(str(tmp_path), 1, state)
    return params_from_jax(load_ckpt_state(str(tmp_path)), "cpu")


def _accumulation_run(task, state, batches, grads_fn, jopts, tmp_path):
    """Run the port's train_step over ``batches`` (a checkpoint round trip
    after the first), holding after each mini-step every parameter leaf to
    JAX's MultiSteps update and NaN guard on the port's own gradients
    (``grads_fn(state, batch)`` → (G grads, D grads, D gate))."""
    names = ("params_g", "params_d")
    jstate = {n: _flat(tree_leaves(tree_map(torch.Tensor.numpy, state[n]))) for n in names}
    jopt_state = {n: o.init(jstate[n]) for n, o in zip(names, jopts)}
    moved = []
    for i, batch in enumerate(batches):
        grads_g, grads_d, d_gate = grads_fn(state, batch)
        for n, o, grads, gate in zip(names, jopts, (grads_g, grads_d), (True, d_gate)):
            flat = _flat([g.numpy() for g in grads])
            if not gate:
                flat = flat * jnp.nan                      # a gate that is off drops the step
            jstate[n], jopt_state[n] = _jax_update(flat, jstate[n], jopt_state[n], o)
        old = [t.clone() for t in tree_leaves(state["params_g"])]
        state, metrics = task.train_step(state, batch)
        moved.append(any(not torch.equal(a, b) for a, b in
                         zip(tree_leaves(state["params_g"]), old)))
        for n in names:
            _close(_flat([t.numpy() for t in tree_leaves(state[n])]), jstate[n], atol=1e-6,
                   rtol=0)
            js, ps = jopt_state[n], state["opt_" + n[-1]]
            assert int(ps["mini_step"]) == int(js.mini_step)
            assert int(ps["inner"]["count"]) == int(_inner_adam(js).count)
            _close(_flat([t.numpy() for t in tree_leaves(ps["acc"])]), js.acc_grads,
                   atol=1e-6, rtol=1e-5)
        if i == 0:
            state = _resume(state, tmp_path)
    return state, moved


def test_vocoder_accumulation_matches_jax(tmp_path):
    """accumulate_grad_batches 2 over 4 mini-steps, a NaN batch between the
    third and the fourth, a checkpoint round trip between the first and the
    second: the parameters move on mini-steps 2 and 4 only."""
    hp = dict(VOC_HP, accumulate_grad_batches=2)
    jtask, task = JVocoderTask(hp), VocoderTask(hp, device="cpu")
    pg_np, pd_np = _voc_params(jtask)
    state = task.init_state(torch.Generator().manual_seed(0))
    state["params_g"], state["params_d"] = (params_from_jax(pg_np, "cpu"),
                                            params_from_jax(pd_np, "cpu"))
    state["opt_g"], state["opt_d"] = (task.opt_g.init(state["params_g"]),
                                      task.opt_d.init(state["params_d"]))
    batches = [_voc_batch(10 + i, 8) for i in range(5)]
    batches[3]["wavs"][0, 100] = np.nan

    def grads_fn(state, batch):
        with torch.backends.mkldnn.flags(enabled=False):
            return (*_port_voc_grads(task, state, batch), True)

    with torch.backends.mkldnn.flags(enabled=False):
        state, moved = _accumulation_run(task, state, batches, grads_fn,
                                         (jtask.opt_g, jtask.opt_d), tmp_path)
    assert moved == [False, True, False, False, True]
    assert int(state["step"]) == 5 and int(state["opt_g"]["gradient_step"]) == 2


def test_conan_accumulation_matches_jax(tmp_path):
    """As for the vocoder, ConanTask (both optimizers, the discriminator's
    gated by its phase and window fit) from step 0. The NaN is an F0 value
    at an unvoiced frame: it reaches the F0 loss, not the VQ's EMA update,
    which both packages apply outside the guard (a NaN mel would poison the
    codebook in either, as it would the reference's)."""
    from tests.test_torch_conan_train import _batch as conan_batch, _vq_state0

    hp = dict(CONAN_HP, accumulate_grad_batches=2)
    jtask, task = JConanTask(hp), ConanTask(hp, device="cpu")
    state = task.init_state(torch.Generator().manual_seed(0))
    state["params_g"] = params_from_jax(numpy_params(jtask.model.init, 1), "cpu")
    state["params_d"] = params_from_jax(numpy_params(jtask.mel_disc.init, 2), "cpu")
    state["vq_state"] = params_from_jax(_vq_state0(hp["nVQ"], hp["hidden_size"]), "cpu")
    state["opt_g"], state["opt_d"] = (task.opt_g.init(state["params_g"]),
                                      task.opt_d.init(state["params_d"]))
    batches = [conan_batch(20 + i) for i in range(5)]
    batches[3]["f0"][0, int(np.flatnonzero(batches[3]["uv"][0])[0])] = np.nan

    def grads_fn(state, batch):
        b = task._batch(batch, False)
        pg = _with_grad(state["params_g"])
        gtot, _, out = task._gen_losses(pg, state["params_d"], state["vq_state"], b,
                                        state["step"], None, False)
        pd = _with_grad(state["params_d"])
        dtot, _, fit = task._disc_losses(pd, b["mels"], out["mel_out"].detach(), None)
        gate = bool(fit) and int(state["step"]) >= hp["disc_start_steps"]
        return _grads(gtot, pg), _grads(dtot, pd), gate

    state, moved = _accumulation_run(task, state, batches, grads_fn,
                                     (jtask.opt_g, jtask.opt_d), tmp_path)
    assert moved == [False, True, False, False, True]


@pytest.mark.parametrize("kind", ["emformer", "postnet"])
def test_emformer_and_postnet_ignore_accumulation(kind):
    """EmformerTask and PostnetTask take accumulate_grad_batches and ignore
    it, as the JAX package's do: the port's step with the flag equals JAX's
    optimizer of the flagged task (a plain AdamW chain, no MultiSteps)
    applied to the port's gradients, and the port's own step without it."""
    if kind == "emformer":
        from tests.test_torch_emformer_train import HP, SMALL, _batch
        from conan_tpu.models.emformer import EmformerConfig as JC
        from conan_tpu.models.emformer import EmformerDistillModel as JM
        from conan_tpu_torch.models.emformer import EmformerConfig, EmformerDistillModel

        hp = dict(HP, accumulate_grad_batches=2)
        jtask, task = JEmformerTask(hp), EmformerTask(hp, device="cpu")
        task.model = EmformerDistillModel(EmformerConfig(**SMALL))
        plain = EmformerTask(HP, device="cpu")
        plain.model = task.model
        p_np = numpy_params(JM(JC(**SMALL)).init, 1)
        state = {"params": params_from_jax(p_np, "cpu"),
                 "step": torch.zeros((), dtype=torch.int32)}
        batch = _batch(10)
        loss = lambda p: task._loss(p, batch)[0]  # noqa: E731
    else:
        from tests.test_torch_postnet import POST_HP, _batch, _vq_state

        hp = dict(POST_HP, accumulate_grad_batches=2)
        jconan = JConanTask(dict(POST_HP, f0_gen="orig"))
        pg_np = numpy_params(jconan.model.init, 1)
        vq_np = _vq_state(POST_HP["nVQ"], POST_HP["hidden_size"], 1.0)
        jtask = JPostnetTask(hp, pg_np, vq_np)
        task = PostnetTask(hp, pg_np, vq_np, device="cpu")
        plain = PostnetTask(POST_HP, pg_np, vq_np, device="cpu")
        gen = torch.Generator().manual_seed(3)
        t, x0 = task.postnet.flow.draws(task.postnet.target(_t(_batch(6)["mels"])), gen)
        task.postnet.flow.draws = plain.postnet.flow.draws = lambda x1, generator: (t, x0)
        p_np = numpy_params(jtask.postnet.init, 4)
        state = {"params": params_from_jax(p_np, "cpu"),
                 "step": torch.zeros((), dtype=torch.int32), "frozen": task.frozen}
        batch = _batch(6)
        b = {k: _t(v) for k, v in batch.items()}
        loss = lambda p: task._loss(p, state["frozen"], b, None)  # noqa: E731
    assert isinstance(task.opt, PO.AdamW)
    assert not isinstance(jtask.opt, optax.MultiSteps)
    state["opt"] = task.opt.init(state["params"])
    p = _with_grad(state["params"])
    grads = _grads(loss(p), p)
    new, metrics = task.train_step(state, batch)
    new_plain, _ = plain.train_step(state, batch)
    assert float(metrics["skipped"]) == 0.0
    for a, c in zip(tree_leaves(new["params"]), tree_leaves(new_plain["params"])):
        assert torch.equal(a, c)
    flat_old = _flat(jax.tree.leaves(p_np))
    want = _jax_update(_flat([g.numpy() for g in grads]), flat_old, jtask.opt.init(flat_old),
                       jtask.opt)[0]
    _close(_flat([x.numpy() for x in tree_leaves(new["params"])]), want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the speaker options
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option", ["use_spk_id", "use_spk_embed"])
def test_conan_step_with_speaker_option_matches_jax(option):
    """One ConanTask step with the speaker-id embedding added to the style,
    or with the batch's pre-extracted embedding in place of the reference
    encoder's, against JAX's (dropout off, crops at 0): the generator's
    losses, gradients (the reference encoder's zero where the embedding
    replaces it) and updated parameters."""
    from tests.test_torch_conan_train import _batch as conan_batch, _vq_state0

    hp = dict(CONAN_HP, **{option: True, "num_spk": 7})
    jtask, task = JConanTask(hp), ConanTask(hp, device="cpu")
    pg_np = numpy_params(jtask.model.init, 1)
    pd_np = numpy_params(jtask.mel_disc.init, 2)
    vq_np = _vq_state0(hp["nVQ"], hp["hidden_size"])
    assert ("spk_id_proj" in pg_np) == (option == "use_spk_id")
    batch = conan_batch(30)
    batch["spk_ids"] = np.asarray([3, 5], np.int64)
    if option == "use_spk_embed":
        batch["spk_embed"] = np.random.default_rng(31).standard_normal(
            (B, hp["hidden_size"])).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["ref_mels"] = jbatch["mels"]
    gen_fn, _ = jax_conan_step_fns(jtask)
    (gtot_j, (gl_j, _)), grads_g_j = gen_fn(pg_np, pd_np, vq_np, jbatch, jnp.int32(0),
                                            jax.random.PRNGKey(0), None, True)

    state = task.init_state(torch.Generator().manual_seed(0))
    state.update(params_g=params_from_jax(pg_np, "cpu"), params_d=params_from_jax(pd_np, "cpu"),
                 vq_state=params_from_jax(vq_np, "cpu"))
    state["opt_g"], state["opt_d"] = (task.opt_g.init(state["params_g"]),
                                      task.opt_d.init(state["params_d"]))
    b = task._batch(batch, False)
    pg = _with_grad(state["params_g"])
    gtot, _, out = task._gen_losses(pg, state["params_d"], state["vq_state"], b, state["step"],
                                    None, False)
    grads_g = _grads(gtot, pg)
    new, metrics = task.train_step(state, batch)
    want = jax.tree.leaves(grads_g_j)
    for g, w in zip(grads_g, want):
        assert g.shape == w.shape and _rel_l2(g, w) < 1e-3
    if option == "use_spk_embed":          # the reference encoder is not run
        enc = {id(t) for t in tree_leaves(pg["global_encoder"])
               + tree_leaves(pg["global_conv_in"])}
        assert sum(id(t) in enc for t in tree_leaves(pg)) == len(enc)
        for leaf, g in zip(tree_leaves(pg), grads_g):
            assert id(leaf) not in enc or float(g.abs().max()) == 0.0
    for k, w in {**gl_j, "total_g": gtot_j}.items():
        _close(metrics[k], w, atol=0)
    flat_old = _flat(jax.tree.leaves(pg_np))
    applied = _jax_update(_flat([g.numpy() for g in grads_g]), flat_old,
                          jtask.opt_g.init(flat_old), jtask.opt_g)[0]
    _close(_flat([x.numpy() for x in tree_leaves(new["params_g"])]), applied, atol=1e-6,
           rtol=0)
