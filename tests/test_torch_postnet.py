"""The port's rectified-flow training (``RectifiedFlow.p_losses``, the flow
F0 loss in ``ConanTask``), the mel postnet (``ConanPostnet``,
``PostnetTask``), ``data/spec_stats.py`` and the postnet through the training
CLI, against the JAX package's, on the CPU.

Randomness: the port draws the flow's step t and noise x0 from a
``torch.Generator``, not ``jax.random``'s stream. So both sides run with the
same draws: the JAX side's own functions draw from a fixed key, and the
port's ``draws`` is replaced on the instance under test by the values JAX's
code draws from that key (the arithmetic of ``conan_tpu/models/conan/
flow.py:190-202``, ``postnet.py:80-86`` and ``model.py:218-224``).

Tolerances, as tests/test_torch_conan_train.py's (fp32 on both sides, sums
in other orders): losses and values rtol 1e-5 (atol 1e-6), sampled mels
atol 1e-5; gradients a relative L2 error of 1e-3 per leaf and 1e-4 over each
whole tree; parameters after the step atol 1e-6 where JAX's gradient is not
at rounding level (|g| > 1e-6), where Adam's first step is ±lr by sign.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from conan_tpu.data.record_store import RecordWriter as JRecordWriter
from conan_tpu.data.spec_stats import compute as jax_spec_stats
from conan_tpu.models.conan.flow import DiffNet as JDiffNet
from conan_tpu.models.conan.flow import DiffNetConfig as JDiffNetConfig
from conan_tpu.models.conan.flow import RectifiedFlow as JRectifiedFlow
from conan_tpu.models.conan.flow import ReflowConfig as JReflowConfig
from conan_tpu.models.conan.postnet import ConanPostnet as JConanPostnet
from conan_tpu.models.conan.postnet import PostnetConfig as JPostnetConfig
from conan_tpu.train.tasks import ConanTask as JConanTask
from conan_tpu.train.tasks import PostnetTask as JPostnetTask

from conan_tpu_torch.checkpoint import get_all_checkpoints, params_from_jax, tree_leaves
from conan_tpu_torch.data import run_binarize, spec_stats
from conan_tpu_torch.models.conan.flow import (DiffNet, DiffNetConfig, RectifiedFlow,
                                               ReflowConfig)
from conan_tpu_torch.models.conan.postnet import ConanPostnet, PostnetConfig
from conan_tpu_torch.train import run
from conan_tpu_torch.train.tasks import ConanTask, PostnetTask

from tests.test_torch_train_cli import AUDIO_HP, corpus  # noqa: F401
from tests.test_train_steps import CONAN_HP
from tests.torch_port_util import jax_conan_step_fns, leaf_shapes, numpy_params
from tests.torch_port_util import one_torch_thread  # noqa: F401

NET = dict(residual_layers=2, residual_channels=8, dilation_cycle_length=2)
B, T, TR = 2, 48, 40
_SPEC = np.random.default_rng(9)
SPEC_MIN = [float(v) for v in -6.0 + 0.5 * _SPEC.random(80)]
SPEC_MAX = [float(v) for v in 0.5 * _SPEC.random(80)]
POST_HP = dict(CONAN_HP, **NET, timesteps=1000, K_step=4, flow_loss_type="l1", lr=5e-4,
               decay_steps=50000, spec_min=SPEC_MIN, spec_max=SPEC_MAX, vq_start=1, forcing=3,
               train_precision="highest")
FLOW_HP = dict(CONAN_HP, vq_start=1, forcing=3, disc_start_steps=4, random_speaker_steps=5,
               f0_gen="flow", f0_residual_layers=2, f0_residual_channels=8,
               f0_dilation_cycle_length=2, f0_K_step=4, train_precision="highest")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=1e-6, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _grads_close(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel_l2(g, w) < 1e-3
    flat = lambda xs: np.concatenate([np.ravel(np.asarray(x)) for x in xs])  # noqa: E731
    assert _rel_l2(flat(got), flat(want)) < 1e-4


def _batch(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"content": rng.integers(0, 100, (B, T)),
             "mels": (rng.standard_normal((B, T, 80)) * 0.5 - 3.0).astype(np.float32),
             "ref_mels": (rng.standard_normal((B, TR, 80)) * 0.5 - 3.0).astype(np.float32),
             "f0": (rng.standard_normal((B, T)) * 0.5 + 7.5).astype(np.float32),
             "uv": (rng.random((B, T)) < 0.25).astype(np.float32)}
    batch["content"][1, 40:] = -1
    batch["mels"][1, 40:] = 0.0
    batch["f0"][1, 40:] = 0.0
    batch["uv"][1, 40:] = 0.0
    batch["ref_mels"][1, 30:] = 0.0
    return batch


def _vq_state(n: int, dim: int, initialized: float) -> dict:
    emb = np.random.default_rng(4).uniform(-1, 1, (n, dim)).astype(np.float32)
    return {"embedding": emb, "ema_count": np.ones(n, np.float32), "ema_weight": emb.copy(),
            "initialized": np.asarray(initialized, np.float32)}


# ---------------------------------------------------------------------------
# the flow's loss and the postnet's loss and sampler
# ---------------------------------------------------------------------------

def _flows(loss_type: str):
    cfg = dict(in_dims=3, encoder_hidden=6, **NET)
    rc = dict(timesteps=1000, k_step=4, loss_type=loss_type, sample_clip=False)
    return (JRectifiedFlow(JDiffNet(JDiffNetConfig(**cfg)), JReflowConfig(**rc)),
            RectifiedFlow(DiffNet(DiffNetConfig(**cfg)), ReflowConfig(**rc)))


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
@pytest.mark.parametrize("masked", [False, True])
def test_p_losses_matches_jax(loss_type, masked):
    """The velocity loss and its parameter gradients, JAX's x0 (its first
    split of the key) handed to the port."""
    jflow, flow = _flows(loss_type)
    p_np = numpy_params(jflow.net.init, 1)
    rng = np.random.default_rng(2)
    x1 = rng.standard_normal((B, 12, 3)).astype(np.float32)
    cond = rng.standard_normal((B, 12, 6)).astype(np.float32)
    t = np.array([3, 870], np.int32)
    nonpad = (rng.random((B, 12)) < 0.7).astype(np.float32) if masked else None
    key = jax.random.PRNGKey(7)

    def jloss(p):
        return jflow.p_losses(p, x1, jnp.asarray(t), cond, key, nonpadding=nonpad)

    want, want_g = jax.value_and_grad(jloss)(p_np)
    x0 = np.asarray(jax.random.normal(jax.random.split(key)[0], x1.shape))
    p = params_from_jax(p_np, "cpu")
    leaves = [x.requires_grad_(True) for x in tree_leaves(p)]
    got = flow.p_losses(p, _t(x1), _t(t), _t(cond), _t(x0),
                        nonpadding=None if nonpad is None else _t(nonpad))
    _close(got.detach(), want)
    _grads_close([g.numpy() for g in torch.autograd.grad(got, leaves)],
                 jax.tree.leaves(want_g))


def test_draws_come_from_the_generator():
    _, flow = _flows("l1")
    x1 = torch.zeros(3, 5, 2)
    t, x0 = flow.draws(x1, torch.Generator().manual_seed(4))
    t2, x02 = flow.draws(x1, torch.Generator().manual_seed(4))
    assert t.dtype == torch.int64 and t.shape == (3,) and x0.shape == x1.shape
    assert bool(((t >= 0) & (t < 1000)).all())
    assert torch.equal(t, t2) and torch.equal(x0, x02)
    t3, x03 = flow.draws(x1, None)                   # None: seeded 0, the same every call
    assert torch.equal(x03, flow.draws(x1, None)[1]) and torch.equal(t3, flow.draws(x1, None)[0])


def _postnets():
    kw = dict(hidden_size=6, n_mels=80, timesteps=1000, k_step=4, loss_type="l1", **NET,
              spec_min=tuple(SPEC_MIN), spec_max=tuple(SPEC_MAX))
    jpost = JConanPostnet(JPostnetConfig(**kw))
    return jpost, ConanPostnet(PostnetConfig(**kw)), numpy_params(jpost.init, 3)


def _postnet_inputs(seed: int):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((B, 10, 80)) - 3).astype(np.float32),
            rng.standard_normal((B, 10, 6)).astype(np.float32),
            (rng.standard_normal((B, 10, 80)) - 3).astype(np.float32))


def test_postnet_config_and_tree_match_jax():
    hp = dict(POST_HP, hidden_size=6)
    assert PostnetConfig.from_hparams(hp) == PostnetConfig(**vars(JPostnetConfig.from_hparams(
        hp)))
    jpost, post, p_np = _postnets()
    assert leaf_shapes(post.init(torch.Generator().manual_seed(0))) == leaf_shapes(p_np)


def test_postnet_loss_matches_jax():
    """ConanPostnet.loss: JAX draws t from the key's first split and x0
    through p_losses from the second's first."""
    jpost, post, p_np = _postnets()
    coarse, dec_inp, gt = _postnet_inputs(5)
    key = jax.random.PRNGKey(8)
    want, want_g = jax.value_and_grad(lambda p: jpost.loss(p, coarse, dec_inp, gt, key))(p_np)
    r1, r2 = jax.random.split(key)
    t = np.asarray(jax.random.randint(r1, (B,), 0, 1000))
    x0 = np.asarray(jax.random.normal(jax.random.split(r2)[0], gt.shape))
    p = params_from_jax(p_np, "cpu")
    leaves = [x.requires_grad_(True) for x in tree_leaves(p)]
    got = post.loss(p, _t(coarse), _t(dec_inp), _t(gt), _t(t), _t(x0))
    _close(got.detach(), want)
    _grads_close([g.numpy() for g in torch.autograd.grad(got, leaves)],
                 jax.tree.leaves(want_g))


@pytest.mark.parametrize("cfg_scale", [1.0, 2.5])
def test_postnet_sample_matches_jax(cfg_scale):
    """The refined mel from the same noise; with cfg_scale 2.5 an
    unconditional decoder_inp guides each Euler step."""
    jpost, post, p_np = _postnets()
    coarse, dec_inp, noise = _postnet_inputs(6)
    ucond = np.zeros_like(dec_inp) if cfg_scale != 1.0 else None
    want = jpost.sample(p_np, coarse, dec_inp, None, noise=noise, cfg_scale=cfg_scale,
                        ucond_inp=ucond)
    got = post.sample(params_from_jax(p_np, "cpu"), _t(coarse), _t(dec_inp), _t(noise),
                      ucond_inp=None if ucond is None else _t(ucond), cfg_scale=cfg_scale)
    assert got.shape == (B, 10, 80)
    _close(got, want, atol=1e-5, rtol=1e-5)
    if cfg_scale != 1.0:
        plain = post.sample(params_from_jax(p_np, "cpu"), _t(coarse), _t(dec_inp), _t(noise))
        assert float((plain - got).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# ConanTask with f0_gen: flow
# ---------------------------------------------------------------------------

FLOW_KEY = jax.random.PRNGKey(11)


def _jax_flow_draws(shape):
    """What JAX's _pitch_flow draws from FLOW_KEY: t, then x0 from the first
    split of fold_in(key, 1)."""
    t = jax.random.randint(FLOW_KEY, (shape[0],), 0, FLOW_HP.get("f0_timesteps", 1000))
    x0 = jax.random.normal(jax.random.split(jax.random.fold_in(FLOW_KEY, 1))[0], shape)
    return _t(np.asarray(t)), _t(np.asarray(x0))


def test_conan_flow_f0_step_matches_jax():
    """One ConanTask step with the flow F0 loss (step 0: before VQ, forced):
    the generator loss, every metric (``pflow`` in place of ``fdiff``) and
    the generator's gradients against JAX's, dropout off on both sides and
    the flow's draws JAX's; then the port's whole train_step reports the
    same losses and moves the F0 DiffNet."""
    jtask = JConanTask(FLOW_HP)
    pitch_flow = jtask.model._pitch_flow
    jtask.model._pitch_flow = lambda *a, **k: pitch_flow(*a, **{**k, "rng": FLOW_KEY,
                                                                "train": False})
    gen_fn, _ = jax_conan_step_fns(jtask)
    pg_np = numpy_params(jtask.model.init, 1)
    pd_np = numpy_params(jtask.mel_disc.init, 2)
    vq_np = _vq_state(FLOW_HP["nVQ"], FLOW_HP["hidden_size"], 0.0)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["ref_mels"] = jbatch["mels"]
    (gtot_j, (gl_j, _)), grads_j = gen_fn(pg_np, pd_np, vq_np, jbatch, jnp.int32(0),
                                          jax.random.PRNGKey(0), None, True)
    assert "pflow" in gl_j and "fdiff" not in gl_j

    task = ConanTask(FLOW_HP, device="cpu")
    task.model.f0_flow.draws = lambda x1, generator: _jax_flow_draws(tuple(x1.shape))
    pg = params_from_jax(pg_np, "cpu")
    leaves = [x.requires_grad_(True) for x in tree_leaves(pg)]
    gtot, gl, _ = task._gen_losses(pg, params_from_jax(pd_np, "cpu"),
                                   params_from_jax(vq_np, "cpu"), task._batch(batch, False),
                                   torch.tensor(0), None, False)
    assert set(gl) == set(gl_j)
    for k, v in gl_j.items():
        _close(gl[k].detach(), v, rtol=1e-4, atol=0)
    _close(gtot.detach(), gtot_j, rtol=1e-4, atol=0)
    _grads_close([g.numpy() for g in torch.autograd.grad(gtot, leaves)],
                 jax.tree.leaves(grads_j))
    state = task.init_state(torch.Generator().manual_seed(0))
    state.update(params_g=params_from_jax(pg_np, "cpu"), params_d=params_from_jax(pd_np, "cpu"),
                 vq_state=params_from_jax(vq_np, "cpu"))
    state["opt_g"], state["opt_d"] = task.opt_g.init(state["params_g"]), \
        task.opt_d.init(state["params_d"])
    new, metrics = task.train_step(state, batch)
    assert float(metrics["skipped"]) == 0.0
    _close(metrics["pflow"], gl_j["pflow"], rtol=1e-4, atol=0)
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(new["params_g"]["f0_net"]),
                                                   tree_leaves(state["params_g"]["f0_net"]))]
    assert all(moved)


# ---------------------------------------------------------------------------
# PostnetTask
# ---------------------------------------------------------------------------

def test_postnet_task_step_matches_jax():
    """PostnetTask.train_step against JAX's jitted one from the same frozen
    Conan (its VQ on at step 200000, the aligner not forced), postnet
    parameters and batch: the loss, the gradients and every updated leaf;
    the frozen tree comes back as it went in."""
    jconan = JConanTask(dict(POST_HP, f0_gen="orig"))
    pg_np = numpy_params(jconan.model.init, 1)
    vq_np = _vq_state(POST_HP["nVQ"], POST_HP["hidden_size"], 1.0)
    jtask = JPostnetTask(POST_HP, pg_np, vq_np)
    p_np = numpy_params(jtask.postnet.init, 4)
    jstate = {"params": p_np, "opt": jtask.opt.init(p_np), "step": jnp.zeros((), jnp.int32),
              "frozen": {"conan": pg_np, "vq": vq_np}}
    batch = _batch(6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(12)
    jnew, jm = jax.jit(jtask.train_step)(jstate, jbatch, key)
    want_g = jax.grad(jtask._loss)(p_np, jstate["frozen"], jbatch, key)
    r2 = jax.random.split(key)[1]
    ra, rb = jax.random.split(r2)
    t = _t(np.asarray(jax.random.randint(ra, (B,), 0, 1000)))
    x0 = _t(np.asarray(jax.random.normal(jax.random.split(rb)[0], (B, T, 80))))

    task = PostnetTask(POST_HP, pg_np, vq_np, device="cpu")
    task.postnet.flow.draws = lambda x1, generator: (t, x0)
    state = task.init_state(torch.Generator().manual_seed(0))
    state["params"] = params_from_jax(p_np, "cpu")
    state["opt"] = task.opt.init(state["params"])
    b = {k: _t(v) for k, v in batch.items()}
    p = params_from_jax(p_np, "cpu")
    leaves = [x.requires_grad_(True) for x in tree_leaves(p)]
    loss = task._loss(p, state["frozen"], b, None)
    got_g = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    _grads_close(got_g, jax.tree.leaves(want_g))
    new, metrics = task.train_step(state, batch)
    assert set(metrics) == set(jm) == {"flow", "skipped"}
    _close(metrics["flow"], jm["flow"], rtol=1e-5, atol=0)
    assert float(metrics["skipped"]) == float(jm["skipped"]) == 0.0
    assert int(new["step"]) == 1 and new["frozen"] is state["frozen"]
    for got, want, g in zip(tree_leaves(new["params"]), jax.tree.leaves(jnew["params"]),
                            jax.tree.leaves(want_g)):
        got, want, g = got.numpy(), np.asarray(want), np.asarray(g)
        settled = np.abs(g) > 1e-6
        np.testing.assert_allclose(got[settled], want[settled], atol=1e-6, rtol=0)
        assert np.abs(got - want).max() <= 2 * POST_HP["lr"] + 1e-6


def test_postnet_frozen_forward_is_jax_step_200000():
    """The frozen Conan's mel_out and decoder_inp equal JAX's apply(infer=
    False, global_step=200000) on the same weights (VQ quantizing, no
    forcing, no dropout)."""
    jconan = JConanTask(dict(POST_HP, f0_gen="orig"))
    pg_np = numpy_params(jconan.model.init, 1)
    vq_np = _vq_state(POST_HP["nVQ"], POST_HP["hidden_size"], 1.0)
    batch = _batch(7)
    out_j = jconan.model.apply(pg_np, jnp.asarray(batch["content"]),
                               ref=jnp.asarray(batch["ref_mels"]), vq_state=vq_np,
                               f0=jnp.asarray(batch["f0"]), uv=jnp.asarray(batch["uv"]),
                               infer=False, global_step=200000, rng=None,
                               vq_start=POST_HP["vq_start"], forcing_steps=POST_HP["forcing"])
    task = PostnetTask(POST_HP, pg_np, vq_np, device="cpu")
    out = task.frozen_forward(task.frozen, {k: _t(v) for k, v in batch.items()})
    for k in ("mel_out", "decoder_inp"):
        assert not out[k].requires_grad
        _close(out[k], out_j[k], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# spec_stats and the CLI
# ---------------------------------------------------------------------------

def test_spec_stats_compute_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    w = JRecordWriter(str(tmp_path / "train"))
    for n in (30, 7, 52):
        w.add_item({"mel": (rng.standard_normal((n, 80)) - 4).astype(np.float32),
                    "item_name": f"u{n}"})
    w.finalize()
    lo, hi = spec_stats.compute(str(tmp_path / "train"))
    jlo, jhi = jax_spec_stats(str(tmp_path / "train"))
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    assert lo.shape == hi.shape == (80,) and bool((lo < hi).all())


def _records(work: str) -> list[dict]:
    with open(os.path.join(work, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_binarize_conan_spec_stats_postnet_and_resume(corpus, tmp_path):  # noqa: F811
    """The postnet from raw data through the port's CLIs on the CPU, each at
    the shipped rung (train_precision default): run_binarize, 2 Conan steps,
    spec_stats (its npz equals compute on the train split), 2 postnet steps
    on that Conan's work dir with spec_min null, then resumed to 3."""
    binary = str(tmp_path / "binary")
    conan_cfg = tmp_path / "conan.yaml"
    conan_cfg.write_text(yaml.safe_dump(dict(
        CONAN_HP, **dict(corpus, binary_data_dir=binary), task_cls="conan",
        binarizer_cls="conan", vq_start=1000, max_updates=2, val_check_interval=2,
        num_ckpt_keep=1, tb_log_interval=1, max_tokens=300, max_sentences=3,
        num_valid_stats=1, train_precision="default")))
    run_binarize.main(["--config", str(conan_cfg), "--device", "cpu"])
    conan_work = str(tmp_path / "conan")
    run.main(["--config", str(conan_cfg), "--exp_name", conan_work, "--device", "cpu"])
    assert [os.path.basename(p) for p in get_all_checkpoints(conan_work)] == [
        "model_ckpt_steps_2.ckpt"]
    spec_stats.main(["--config", str(conan_cfg)])
    stats = np.load(os.path.join(binary, "spec_stats.npz"))
    lo, hi = spec_stats.compute(os.path.join(binary, "train"))
    np.testing.assert_array_equal(stats["spec_min"], lo)
    np.testing.assert_array_equal(stats["spec_max"], hi)

    post_cfg = tmp_path / "post.yaml"
    post_cfg.write_text(yaml.safe_dump(dict(
        base_config=str(conan_cfg), task_cls="postnet", fs2_ckpt_dir=conan_work, **NET,
        timesteps=1000, K_step=4, flow_loss_type="l1", lr=5e-4, decay_steps=50000,
        spec_min=None, spec_max=None)))
    post_work = str(tmp_path / "post")
    run.main(["--config", str(post_cfg), "--exp_name", post_work, "--device", "cpu"])
    hp = yaml.safe_load(open(os.path.join(post_work, "config.yaml")))
    assert hp["task_cls"] == "postnet" and hp["train_precision"] == "default"
    task, kind = run.build_task(hp, device="cpu")
    assert kind == "postnet" and task.precision == "default"
    np.testing.assert_allclose(task.postnet.cfg.spec_min, lo)
    assert run.build_valid_fn(hp, task, kind) is None
    recs = _records(post_work)
    assert [r["step"] for r in recs if r["prefix"] == "tr"] == [1, 2]
    assert all(np.isfinite(r["flow"]) and r["skipped"] == 0.0 for r in recs)
    run.main(["--exp_name", post_work, "--hparams", "max_updates=3", "--device", "cpu"])
    assert [os.path.basename(p) for p in get_all_checkpoints(post_work)] == [
        "model_ckpt_steps_3.ckpt"]
    assert [r["step"] for r in _records(post_work) if r["prefix"] == "tr"] == [1, 2, 3]
