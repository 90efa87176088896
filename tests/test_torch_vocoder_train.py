"""The port's vocoder GAN training (discriminators, losses, optimizer, one
train step, the training loop) against the JAX package's, on the CPU, where
the port runs the plain versions of kernels K1 and K2.

Sizes: the generator of tests/test_train_steps.py's VOC_HP (width 16), the
discriminators at their fixed widths, B = 2 wavs of 8 mel frames (2560
samples). Parameter trees come from ``jax.eval_shape`` of the JAX inits and
their values from numpy.

Tolerances, all fp32 on both sides with sums in other orders:
  - discriminator logits and feature maps, atol 1e-4 / rtol 1e-4 (the conv
    stacks reach 1024 channels and 41-tap kernels);
  - loss terms, rtol 1e-4;
  - gradients, relative L2 error 1e-3 per leaf (the bound chip_smoke.py holds
    the card's step to) and 1e-4 over each whole tree. The port's side runs
    with ATen's oneDNN convolutions off: their fp32 backward moves a few
    leaves past 1e-3 from a float64 step, where ATen's own convolutions,
    cuDNN and JAX's fp32 stay within it (chip_smoke.py's train check prints
    the card's and the CPU's distance from a float64 step);
  - parameters after the step: atol 1e-6 against JAX's optimizer update and
    NaN guard applied to the port's own gradients; against JAX's whole step,
    a relative L2 error of 2e-2 over the update (new - old) of each tree. A
    first Adam update is -lr · g / (|g| + eps), ±lr wherever |g| >> eps, so
    an entry whose gradient is within fp32 rounding of zero can take the
    other sign and move by 2·lr.
The composed JAX ``train_step`` takes over a minute to compile on the CPU,
so the test runs the functions it composes, in its order, each under
``jax.jit``: ``value_and_grad`` of ``_gen_losses`` and ``_disc_losses``,
then each optax update and ``_gated_update``, on the parameters flattened
into one vector (elementwise but for the global norm, so the same numbers;
compiling them per leaf takes another 20 s).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_tpu.ops.conv import spectral_norm_weight as jax_spectral_norm_weight
from conan_tpu.train import losses as JL
from conan_tpu.train import tasks as jtasks
from conan_tpu.train.tasks import VocoderTask as JVocoderTask

from conan_tpu_torch.checkpoint import (load_ckpt_state, params_from_jax, tree_leaves,
                                        tree_to_numpy)
from conan_tpu_torch.ops.conv import spectral_norm_weight
from conan_tpu_torch.train import losses as PL
from conan_tpu_torch.train.tasks import VocoderTask
from conan_tpu_torch.train.trainer import Trainer

from tests.test_train_steps import VOC_HP
from tests.torch_port_util import leaf_shapes, numpy_params
from tests.torch_port_util import one_torch_thread  # noqa: F401

B, FRAMES, HOP = 2, 8, 320


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def setup():
    jtask = JVocoderTask(VOC_HP)
    pg = numpy_params(jtask.gen.init, 1)
    pd = numpy_params(lambda k: {"mpd": jtask.mpd.init(k), "msd": jtask.msd.init(k)}, 2)
    rng = np.random.default_rng(3)
    batch = {"mels": rng.standard_normal((B, FRAMES, 80)).astype(np.float32),
             "wavs": (0.1 * rng.standard_normal((B, FRAMES * HOP))).astype(np.float32)}
    return jtask, VocoderTask(VOC_HP, device="cpu"), pg, pd, batch


def test_discriminators_match_jax(setup):
    jtask, task, _, pd_np, batch = setup
    pd = params_from_jax(pd_np, "cpu")
    y = batch["wavs"][..., None]
    y_hat = (0.5 * np.random.default_rng(4).standard_normal(y.shape)).astype(np.float32)
    for name, jd, d, to_jax_layout in (("mpd", jtask.mpd, task.mpd, (0, 2, 3, 1)),
                                       ("msd", jtask.msd, task.msd, (0, 1, 2))):
        want = jax.jit(jd.apply)(pd_np[name], y, y_hat)
        got = d.apply(pd[name], _t(y), _t(y_hat))
        for g_list, w_list in zip(got[:2], want[:2]):           # logits
            assert len(g_list) == len(w_list) == len(d.discs)
            for g, w in zip(g_list, w_list):
                _close(g, w)
        for g_disc, w_disc in zip(got[2] + got[3], want[2] + want[3]):   # feature maps
            for g, w in zip(g_disc, w_disc):
                _close(g.permute(*to_jax_layout), w)


def test_spectral_norm_matches_jax():
    w = np.random.default_rng(5).standard_normal((16, 4, 41)).astype(np.float32)
    _close(spectral_norm_weight(_t(w)), jax_spectral_norm_weight(jnp.asarray(w)), atol=1e-6)
    wt = _t(w).requires_grad_(True)
    (spectral_norm_weight(wt) ** 3).sum().backward()
    want = jax.grad(lambda x: jnp.sum(jax_spectral_norm_weight(x) ** 3))(jnp.asarray(w))
    _close(wt.grad, want, atol=1e-5)


def test_losses_match_jax():
    rng = np.random.default_rng(6)
    y = (0.2 * rng.standard_normal((B, 4000))).astype(np.float32)
    y_hat = (0.2 * rng.standard_normal((B, 4000))).astype(np.float32)
    for got, want in (
            (PL.multi_res_gan_mel_loss(_t(y), _t(y_hat)), JL.multi_res_gan_mel_loss(y, y_hat)),
            (PL.multi_res_stft_loss(_t(y), _t(y_hat)), JL.multi_res_stft_loss(y, y_hat))):
        _close(np.asarray(got), np.asarray(want), atol=0, rtol=1e-4)
    outs = [rng.standard_normal((B, n)).astype(np.float32) for n in (7, 3)]
    fmaps = [[rng.standard_normal((B, 5, 4)).astype(np.float32) for _ in range(2)]
             for _ in range(2)]
    pairs = [(PL.discriminator_loss([_t(o) for o in outs], [_t(-o) for o in outs]),
              JL.discriminator_loss(outs, [-o for o in outs])),
             (PL.generator_loss([_t(o) for o in outs]), JL.generator_loss(outs)),
             (PL.feature_loss([[_t(f) for f in d] for d in fmaps],
                              [[_t(-f) for f in d] for d in fmaps]),
              JL.feature_loss(fmaps, [[-f for f in d] for d in fmaps]))]
    for got, want in pairs:
        _close(np.asarray(torch.as_tensor(got)), np.asarray(want), atol=0, rtol=1e-5)


def _flat(tree):
    return jnp.concatenate([jnp.ravel(x) for x in jax.tree.leaves(tree)])


def _unflat(vec, like):
    leaves = jax.tree.leaves(like)
    parts = np.split(np.asarray(vec), np.cumsum([x.size for x in leaves])[:-1])
    return [p.reshape(x.shape) for p, x in zip(parts, leaves)]


@functools.partial(jax.jit, static_argnums=2)
def _jax_update(grads, params, opt):
    """JAX's optimizer update and NaN guard, as its train_step applies them."""
    state = opt.init(params)
    upd, new_opt = opt.update(grads, state, params)
    return jtasks._gated_update(jtasks._tree_finite(grads), params, upd, new_opt, state)[0]


def _jax_step(jtask, pg, pd, batch):
    """JAX's train_step, composed of the functions it calls, each jitted."""
    mel, y = batch["mels"], batch["wavs"]
    (gtot, (gl, y_)), grads_g = jax.jit(jax.value_and_grad(jtask._gen_losses, has_aux=True))(
        pg, pd, mel, y, None)
    (dtot, dl), grads_d = jax.jit(jax.value_and_grad(jtask._disc_losses, has_aux=True))(
        pd, mel, y, jax.lax.stop_gradient(y_), None)
    new_pg = _unflat(_jax_update(_flat(grads_g), _flat(pg), jtask.opt_g), pg)
    new_pd = _unflat(_jax_update(_flat(grads_d), _flat(pd), jtask.opt_d), pd)
    metrics = {**gl, **dl, "total_g": gtot, "total_d": dtot}
    return metrics, grads_g, grads_d, new_pg, new_pd


def test_train_step_matches_jax(setup):
    jtask, task, pg_np, pd_np, batch = setup
    metrics_j, grads_g_j, grads_d_j, pg_j, pd_j = _jax_step(jtask, pg_np, pd_np, batch)
    with torch.backends.mkldnn.flags(enabled=False):
        # the port's gradients, taken as its train_step takes them
        pg = params_from_jax(pg_np, "cpu")
        pd = params_from_jax(pd_np, "cpu")
        leaves_g = [t.requires_grad_(True) for t in tree_leaves(pg)]
        gtot, _, y_ = task._gen_losses(pg, params_from_jax(pd_np, "cpu"), _t(batch["mels"]),
                                       _t(batch["wavs"]))
        grads_g = torch.autograd.grad(gtot, leaves_g)
        leaves_d = [t.requires_grad_(True) for t in tree_leaves(pd)]
        dtot, _ = task._disc_losses(pd, _t(batch["wavs"]), y_.detach())
        grads_d = torch.autograd.grad(dtot, leaves_d)

        state = task.init_state(torch.Generator().manual_seed(0))
        state["params_g"] = params_from_jax(pg_np, "cpu")
        state["params_d"] = params_from_jax(pd_np, "cpu")
        state["opt_g"] = task.opt_g.init(state["params_g"])
        state["opt_d"] = task.opt_d.init(state["params_d"])
        new_state, metrics = task.train_step(state, batch)
    for got, want in ((grads_g, grads_g_j), (grads_d, grads_d_j)):
        want = jax.tree.leaves(want)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _rel_l2(g, w) < 1e-3
        assert _rel_l2(_flat([g.numpy() for g in got]), _flat(want)) < 1e-4

    assert set(metrics) == set(metrics_j) | {"skipped"} and float(metrics["skipped"]) == 0.0
    for k, want in metrics_j.items():
        _close(metrics[k], want, atol=0, rtol=1e-4)
    assert int(new_state["step"]) == 1
    for new, old, grads, opt, want in (
            (new_state["params_g"], pg_np, grads_g, jtask.opt_g, pg_j),
            (new_state["params_d"], pd_np, grads_d, jtask.opt_d, pd_j)):
        new = [n.numpy() for n in tree_leaves(new)]
        applied = _unflat(_jax_update(_flat([g.numpy() for g in grads]), _flat(old), opt), old)
        for n, a in zip(new, applied):
            _close(n, a, atol=1e-6, rtol=0)
        old = jax.tree.leaves(old)
        assert _rel_l2(_flat(new) - _flat(old), _flat(want) - _flat(old)) < 2e-2


def test_trainer_fit_writes_metrics_and_checkpoint(setup, tmp_path):
    jtask, _, _, _, batch = setup
    hp = dict(VOC_HP, max_updates=2, tb_log_interval=1, seed=7)
    state = Trainer(VocoderTask(hp, device="cpu"), hp, str(tmp_path)).fit(iter([batch] * 3))
    assert int(state["step"]) == 2
    with open(tmp_path / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r[k]) for r in records for k in ("mel", "a_s", "r_s", "total_g"))
    assert all(r["skipped"] == 0.0 for r in records)
    assert os.path.exists(tmp_path / "model_ckpt_steps_2.ckpt")
    saved = load_ckpt_state(str(tmp_path))
    shapes = jax.eval_shape(lambda k: {"params_g": jtask.gen.init(k),
                                       "params_d": {"mpd": jtask.mpd.init(k),
                                                    "msd": jtask.msd.init(k)}},
                            jax.random.PRNGKey(0))
    assert leaf_shapes({k: saved[k] for k in shapes}) == leaf_shapes(shapes)
    back = params_from_jax(saved["params_g"], "cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(tree_to_numpy(state["params_g"]))):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("override", [dict(use_fm_loss=True), dict(use_cond_disc=True),
                                      dict(use_spec_disc=True), dict(train_precision="bf16"),
                                      dict(train_precision="fast")])
def test_unported_options_raise(override):
    """Unported options raise NotImplementedError naming their ROADMAP item;
    a train_precision outside default/high/highest raises ValueError."""
    if "train_precision" in override:
        with pytest.raises(ValueError, match="train_precision"):
            VocoderTask(dict(VOC_HP, **override), device="cpu")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VocoderTask(dict(VOC_HP, **override), device="cpu")


def test_task_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        VocoderTask(VOC_HP)
