"""The port's Conan acoustic GAN training (the training forward of each
module, the mel discriminator, the losses, the schedules, one ConanTask step
in each schedule phase, the k-means hook) against the JAX package's, on the
CPU.

Sizes: tests/test_train_steps.py's CONAN_HP (hidden 32, nVQ 16, one 32-frame
window of hidden 8), with the schedule gates at vq_start 1, forcing 3,
disc_start_steps 4 and random_speaker_steps 5, so that steps 0, 2, 3, 4 and
5 are the five phases. B = 2 utterances of 96 frames, the second padded after
80 (codes -1, mels 0), and other references of 96 frames, the second padded
after 48. Parameter trees come from ``jax.eval_shape`` of the JAX inits and
their values from numpy. JAX's generator loss is compiled once, for
``use_random_ref=True``: its same-utterance phases get the batch's own mels
as ``ref_mels``, which is what the flag selects.

Randomness: the port draws dropout masks and crop starts from a
``torch.Generator``, not ``jax.random``'s stream, so both sides run with the
random parts fixed: dropout off (``rng=None`` on JAX's component ``apply``s,
no generator on the port's) and the mel discriminator's crops given by
``start_frames`` (the port's step without a generator starts every crop at
frame 0; JAX's step is composed with ``start_frames`` of 0, its model and
discriminator ``apply`` wrapped inside this test). Separate tests check the
port's own draws.

Tolerances, as tests/test_torch_vocoder_train.py's (fp32 on both sides,
sums in other orders): values atol/rtol 1e-4; losses rtol 1e-4; gradients a
relative L2 error of 1e-3 per leaf and 1e-4 over each whole tree; parameters
after the step atol 1e-6 against JAX's optimizer update and NaN guard
applied to the port's own gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_tpu.models.vocoder.discriminators import \
    MultiWindowDiscriminator as JMultiWindowDiscriminator
from conan_tpu.train import losses as JL
from conan_tpu.train import optim as JO
from conan_tpu.train import tasks as jtasks
from conan_tpu.train.tasks import ConanTask as JConanTask

from conan_tpu_torch.checkpoint import params_from_jax, tree_leaves
from conan_tpu_torch.models.vocoder.discriminators import MultiWindowDiscriminator
from conan_tpu_torch.nn.blocks import MultiheadAttention, dropout
from conan_tpu_torch.train import losses as PL
from conan_tpu_torch.train import optim as PO
from conan_tpu_torch.train.tasks import ConanTask

from tests.test_train_steps import CONAN_HP
from tests.torch_port_util import jax_conan_step_fns, numpy_params
from tests.torch_port_util import one_torch_thread  # noqa: F401

HP = dict(CONAN_HP, vq_start=1, forcing=3, disc_start_steps=4, random_speaker_steps=5)
B, T, VALID = 2, 96, 80
# step → use_random_ref: before VQ with forcing; VQ on; forcing off;
# discriminator on; random reference
PHASES = {0: False, 2: False, 3: False, 4: False, 5: True}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"content": rng.integers(0, 100, (B, T)),
             "mels": (rng.standard_normal((B, T, 80)) * 0.5).astype(np.float32),
             "ref_mels": (rng.standard_normal((B, T, 80)) * 0.5).astype(np.float32),
             "f0": (rng.standard_normal((B, T)) * 0.5 + 7.5).astype(np.float32),
             "uv": (rng.random((B, T)) < 0.25).astype(np.float32)}
    batch["content"][1, VALID:] = -1
    batch["mels"][1, VALID:] = 0.0
    batch["f0"][1, VALID:] = 0.0
    batch["uv"][1, VALID:] = 0.0
    batch["ref_mels"][1, 48:] = 0.0
    return batch


def _jax_batch(batch: dict, use_random_ref: bool) -> dict:
    """The batch for JAX's generator loss compiled with use_random_ref=True:
    before the flip, the reference is the utterance itself."""
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if not use_random_ref:
        out["ref_mels"] = out["mels"]
    return out


def _vq_state0(n: int, dim: int) -> dict:
    emb = np.random.default_rng(4).uniform(-1 / 512, 1 / 512, (n, dim)).astype(np.float32)
    return {"embedding": emb, "ema_count": np.zeros(n, np.float32), "ema_weight": emb.copy(),
            "initialized": np.zeros((), np.float32)}


@pytest.fixture(scope="module")
def setup():
    jtask = JConanTask(HP)
    pg = numpy_params(jtask.model.init, 1)
    pd = numpy_params(jtask.mel_disc.init, 2)
    batch = _batch()
    vq0 = _vq_state0(HP["nVQ"], HP["hidden_size"])
    # JAX's hook as it is, its feature extractor jitted on this instance
    # for the call
    pre_vq = jtask.model.prosody.pre_vq
    jtask.model.prosody.pre_vq = jax.jit(lambda p, ref: pre_vq(p, ref))
    try:
        vq_init, done = jtask.host_hook({"params_g": pg, "vq_state": vq0}, 2, batch)
    finally:
        del jtask.model.prosody.pre_vq
    assert done
    return jtask, ConanTask(HP, device="cpu"), pg, pd, batch, vq0, _np(vq_init["vq_state"])


# ---------------------------------------------------------------------------
# modules in training mode
# ---------------------------------------------------------------------------

def test_attention_weights_match_jax(setup):
    jtask, task, pg, *_ = setup
    lp = pg["aligner"]["layers"][0]["attn"]
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, 12, 32)).astype(np.float32)
    kv = rng.standard_normal((B, 7, 32)).astype(np.float32)
    pad = np.zeros((B, 7), bool)
    pad[1, 5:] = True
    want_o, want_w = jtask.model.aligner.mha.apply(lp, q, kv, kv, pad, rng=None, train=True)
    got_o, got_w = MultiheadAttention(32, 2).apply(params_from_jax(lp, "cpu"), _t(q), _t(kv),
                                                   _t(kv), _t(pad), need_weights=True)
    _close(got_o, want_o)
    _close(got_w, want_w)


@pytest.mark.parametrize("initialized", [False, True])
def test_vq_forward_matches_jax(setup, initialized):
    jtask, task, _, _, _, vq0, vq_init = setup
    state = dict(vq_init if initialized else vq0)
    x = np.random.default_rng(6).standard_normal((B, 24, 32)).astype(np.float32)
    x[1, 20:] = 0.0                                   # padded frames
    # a codeword that gets no frame and has none in its EMA (k-means can
    # leave one empty): its count stays 0 but for the Laplace smoothing
    unused = min(set(range(HP["nVQ"]))
                 - set(np.asarray(jtask.model.prosody.vq.encode(state, x)[1]).ravel()))
    state["ema_count"] = state["ema_count"].copy()
    state["ema_weight"] = state["ema_weight"].copy()
    state["ema_count"][unused], state["ema_weight"][unused] = 0.0, 0.0
    want = jax.jit(lambda st, x: jtask.model.prosody.vq.forward(st, x, train=True))(
        state, jnp.asarray(x))
    got = task.model.prosody.vq.forward(params_from_jax(state, "cpu"), _t(x))
    for g, w in zip(got[:2], want[:2]):               # quantized, commitment loss
        _close(g, w)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[3], want[3])                           # perplexity
    for k in ("embedding", "ema_count", "ema_weight", "initialized"):
        _close(got[4][k], want[4][k], atol=1e-6, rtol=1e-5)
    moved = not np.allclose(np.asarray(want[4]["embedding"]), state["embedding"])
    assert moved == initialized and float(got[4]["initialized"]) == 1.0


def test_kmeans_init_matches_jax(setup):
    jtask, task, _, _, _, vq0, _ = setup
    feats = np.random.default_rng(7).standard_normal((200, 32)).astype(np.float32)
    want = jtask.model.prosody.vq.kmeans_init_host(vq0, feats)
    got = task.model.prosody.vq.kmeans_init_host(params_from_jax(vq0, "cpu"), feats)
    for k in ("embedding", "ema_count", "ema_weight", "initialized"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("forcing", [True, False])
def test_aligner_train_matches_jax(setup, forcing):
    jtask, task, pg, *_ = setup
    rng = np.random.default_rng(8)
    src = rng.standard_normal((B, 40, 32)).astype(np.float32)
    pros = rng.standard_normal((B, 10, 32)).astype(np.float32)
    src[1, 33:] = 0.0
    pros[1, 8:] = 0.0
    src_pad, pros_pad = src[:, :, 0] == 0.0, pros[:, :, 0] == 0.0
    aligner = jax.jit(lambda p, s, k, sp, kp, f: jtask.model.aligner.apply(
        p, s, k, sp, kp, forcing=f, rng=None, train=True))
    want = aligner(pg["aligner"], src, pros, src_pad, pros_pad, jnp.asarray(forcing))
    got = task.model.aligner.apply_train(params_from_jax(pg["aligner"], "cpu"), _t(src),
                                         _t(pros), _t(src_pad), _t(pros_pad),
                                         forcing=torch.tensor(forcing))
    _close(got[0], want[0])
    _close(got[1], want[1], atol=0)
    for g, w in zip(got[2], want[2]):
        _close(g, w)


@pytest.mark.parametrize("step", [0, 2, 4])
def test_conan_train_forward_matches_jax(setup, jax_step_fns, step):
    """Either side of vq_start (1) and of forcing (3). JAX's side is
    ``Conan.apply(train=True, rng=None)`` as its generator loss calls it
    (the step tests' jitted function, so it compiles once)."""
    jtask, task, pg, pd, batch, vq0, vq_init = setup
    vq = vq0 if step < 2 else vq_init
    (_, (_, want)), _ = jax_step_fns[0](pg, pd, vq, _jax_batch(batch, False), jnp.int32(step),
                                        jax.random.PRNGKey(0), None, True)
    got = task.model.apply_train(params_from_jax(pg, "cpu"), params_from_jax(vq, "cpu"),
                                 _t(batch["content"]), _t(batch["mels"]), _t(batch["f0"]),
                                 _t(batch["uv"]), global_step=torch.tensor(step),
                                 vq_start=HP["vq_start"], forcing_steps=HP["forcing"])
    for k in ("mel_out", "uv_pred", "f0_denorm_pred"):
        _close(got[k], want[k])
    for k in ("fdiff", "vq_loss", "ppl", "gloss"):
        _close(got[k], want[k], atol=0)
    for g, w in zip(got["attn"], want["attn"]):
        _close(g, w)
    for k in want["vq_state"]:
        _close(got["vq_state"][k], want["vq_state"][k], atol=1e-6, rtol=1e-5)
    assert (float(want["vq_loss"]) > 0) == (step > HP["vq_start"])


# ---------------------------------------------------------------------------
# the mel discriminator and the losses
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _disc_pair():
    """(JAX's discriminator apply, jitted with dropout off; the port's; the
    shared parameters)."""
    jd = JMultiWindowDiscriminator(time_lengths=(8, 16), freq_length=12, hidden=8)
    japply = jax.jit(lambda p, mel, starts: jd.apply(p, mel, jax.random.PRNGKey(0),
                                                     train=False, start_frames=starts))
    return japply, MultiWindowDiscriminator((8, 16), 12, 8), numpy_params(jd.init, 9)


@pytest.mark.parametrize("starts", [(0, 0), (5, 3), (20, 30)])
def test_window_discriminator_matches_jax(starts):
    """Given crop starts (the last pair past T - w, clamped as a dynamic
    slice is); hidden maps NCHW on the port's side."""
    japply, d, p = _disc_pair()
    mel = (np.random.default_rng(10).standard_normal((3, 40, 12)) + 1.0).astype(np.float32)
    mel[2, 30:] = 0.0
    v, hs, used, fit = japply(p, mel, [jnp.int32(s) for s in starts])
    gv, ghs, gused, gfit = d.apply(params_from_jax(p, "cpu"), _t(mel), start_frames=starts)
    _close(gv, v)
    for g, w in zip(ghs, hs):
        _close(g.permute(0, 2, 3, 1), w)
    assert bool(gfit) and bool(fit)
    assert [int(s) for s in gused] == [min(s, 40 - w) for s, w in zip(starts, (8, 16))]


def test_window_discriminator_fit_matches_jax():
    japply, d, p = _disc_pair()
    long = (np.random.default_rng(11).standard_normal((2, 24, 12)) + 3.0).astype(np.float32)
    padded = np.concatenate([long[:, :10], np.zeros((2, 14, 12), np.float32)], axis=1)
    for mel, want_fit in ((long, True), (long[:, :12], False), (padded, False)):
        starts = [0, 0]
        v, *_, fit = japply(p, mel, [jnp.int32(s) for s in starts])
        gv, *_, gfit = d.apply(params_from_jax(p, "cpu"), _t(mel), start_frames=starts)
        assert bool(fit) == bool(gfit) == want_fit
        _close(gv, v)


def test_mel_losses_match_jax():
    rng = np.random.default_rng(12)
    pred = rng.standard_normal((3, 50, 80)).astype(np.float32)
    target = rng.standard_normal((3, 50, 80)).astype(np.float32)
    target[1, 40:] = 0.0
    target[2, 25:] = 0.0
    for name in ("l1", "mse", "ssim"):
        _close(PL.MEL_LOSSES[name](_t(pred), _t(target)),
               jax.jit(JL.MEL_LOSSES[name])(pred, target), atol=0)

    def jax_add(p, t):
        out = {}
        JL.add_mel_losses(p, t, "l1:0.5|ssim:0.5|mse", out)
        return out

    got, want = {}, jax.jit(jax_add)(pred, target)
    PL.add_mel_losses(_t(pred), _t(target), "l1:0.5|ssim:0.5|mse", got)
    assert list(got) == ["l1", "ssim", "mse"] and set(want) == set(got)
    for k in want:
        _close(got[k], want[k], atol=0)
    img = rng.standard_normal((2, 1, 30, 20)).astype(np.float32) + 6.0
    _close(PL.ssim(_t(img), _t(img[::-1].copy())), jax.jit(JL.ssim)(img, img[::-1]),
           atol=1e-6)
    logits = rng.standard_normal((3, 50)).astype(np.float32) * 4
    targets = (rng.random((3, 50)) < 0.3).astype(np.float32)
    mask = (rng.random((3, 50)) < 0.8).astype(np.float32)
    _close(PL.masked_bce_with_logits(_t(logits), _t(targets), _t(mask), 0.7),
           JL.masked_bce_with_logits(logits, targets, mask, 0.7), atol=0)


def test_schedules_and_weight_decay_match_jax():
    steps = np.array([0, 1, 100, 3999, 4000, 9000], np.int32)
    for hp in (dict(scheduler="warmup", lr=5e-4, warmup_updates=4000),
               dict(scheduler="rsqrt", lr=2.0, warmup_updates=4000, hidden_size=256),
               dict(scheduler="none", lr=3e-4), dict(scheduler="step_lr", lr=1e-3)):
        got = [float(PO.build_schedule(hp)(torch.tensor(s))) for s in steps]
        want = [float(JO.build_schedule(hp)(jnp.int32(s))) for s in steps]
        np.testing.assert_allclose(got, want, rtol=1e-6)
    rng = np.random.default_rng(13)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]}
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    tx = JO.adamw(JO.warmup_schedule(1e-3, 10), weight_decay=0.1, clip_norm=1.0)
    opt = PO.AdamW(PO.warmup_schedule(1e-3, 10), weight_decay=0.1, clip_norm=1.0)
    jstate, pstate = tx.init(params), opt.init(params_from_jax(params, "cpu"))
    for _ in range(3):
        upd, jstate = tx.update(grads, jstate, params)
        pupd, pstate = opt.update(params_from_jax(grads, "cpu"), pstate,
                                  params_from_jax(params, "cpu"))
        for g, w in zip(tree_leaves(pupd), jax.tree.leaves(upd)):
            _close(g, w, atol=1e-9, rtol=1e-5)


# ---------------------------------------------------------------------------
# the whole step, in each schedule phase
# ---------------------------------------------------------------------------

def _flat(tree):
    return jnp.concatenate([jnp.ravel(x) for x in jax.tree.leaves(tree)])


def _unflat(vec, like):
    leaves = jax.tree.leaves(like)
    parts = np.split(np.asarray(vec), np.cumsum([x.size for x in leaves])[:-1])
    return [p.reshape(x.shape) for p, x in zip(parts, leaves)]


@functools.partial(jax.jit, static_argnums=3)
def _jax_update(ok, grads, params, opt):
    """JAX's optimizer update and NaN guard (gated also by ``ok``, the
    discriminator's phase), as its train_step applies them to a fresh
    optimizer state."""
    state = opt.init(params)
    upd, new_opt = opt.update(grads, state, params)
    ok = ok & jtasks._tree_finite(grads)
    return jtasks._gated_update(ok, params, upd, new_opt, state)[0]


@pytest.fixture(scope="module")
def jax_step_fns(setup):
    return jax_conan_step_fns(setup[0])


@pytest.mark.parametrize("step", list(PHASES))
def test_conan_step_matches_jax(setup, jax_step_fns, step):
    jtask, task, pg_np, pd_np, batch, vq0, vq_init = setup
    use_random_ref = PHASES[step]
    vq_np = vq0 if step < 2 else vq_init
    key = jax.random.PRNGKey(0)
    jbatch = _jax_batch(batch, use_random_ref)
    jstep = jnp.int32(step)
    # JAX: the step's pieces, in its order
    (gtot_j, (gl_j, out_j)), grads_g_j = jax_step_fns[0](pg_np, pd_np, vq_np, jbatch, jstep,
                                                         key, None, True)
    mel_p = jax.lax.stop_gradient(out_j["mel_out"])
    (dtot_j, (dl_j, fit_j)), grads_d_j = jax_step_fns[1](pd_np, jbatch["mels"], mel_p, key)
    d_gate = bool(step >= HP["disc_start_steps"]) and bool(fit_j)
    # the port: its gradients as its train_step takes them, then the step
    pg, pd = params_from_jax(pg_np, "cpu"), params_from_jax(pd_np, "cpu")
    leaves_g = [t.requires_grad_(True) for t in tree_leaves(pg)]
    b = task._batch(batch, use_random_ref)
    gtot, _, out = task._gen_losses(pg, params_from_jax(pd_np, "cpu"),
                                    params_from_jax(vq_np, "cpu"), b, torch.tensor(step),
                                    None, use_random_ref)
    grads_g = torch.autograd.grad(gtot, leaves_g)
    leaves_d = [t.requires_grad_(True) for t in tree_leaves(pd)]
    dtot, _, _ = task._disc_losses(pd, b["mels"], out["mel_out"].detach(), None)
    grads_d = torch.autograd.grad(dtot, leaves_d)
    state = task.init_state(torch.Generator().manual_seed(0))
    state.update(params_g=params_from_jax(pg_np, "cpu"), params_d=params_from_jax(pd_np, "cpu"),
                 vq_state=params_from_jax(vq_np, "cpu"),
                 step=torch.tensor(step, dtype=torch.int32))
    state["opt_g"], state["opt_d"] = task.opt_g.init(state["params_g"]), \
        task.opt_d.init(state["params_d"])
    new_state, metrics = task.train_step(state, batch, None, use_random_ref=use_random_ref)

    for got, want in ((grads_g, grads_g_j), (grads_d, grads_d_j)):
        want = jax.tree.leaves(want)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and _rel_l2(g, w) < 1e-3
        assert _rel_l2(_flat([g.numpy() for g in got]), _flat(want)) < 1e-4
    want_m = {**gl_j, **{f"d_{k}": v if d_gate else 0.0 for k, v in dl_j.items()},
              "total_g": gtot_j}
    assert set(metrics) == set(want_m) | {"skipped"} and float(metrics["skipped"]) == 0.0
    for k, want in want_m.items():
        _close(metrics[k], want, atol=0)
    assert float(metrics["a"] != 0) == float(step >= HP["disc_start_steps"])
    for k in out_j["vq_state"]:
        _close(new_state["vq_state"][k], out_j["vq_state"][k], atol=1e-6, rtol=1e-5)
    assert int(new_state["step"]) == step + 1
    for new, old, grads, opt, ok in (
            (new_state["params_g"], pg_np, grads_g, jtask.opt_g, True),
            (new_state["params_d"], pd_np, grads_d, jtask.opt_d, d_gate)):
        applied = _unflat(_jax_update(jnp.asarray(ok), _flat([g.numpy() for g in grads]),
                                      _flat(old), opt), old)
        for n, a in zip(tree_leaves(new), applied):
            _close(n, a, atol=1e-6, rtol=0)
    moved_d = any(not torch.equal(n, o) for n, o in
                  zip(tree_leaves(new_state["params_d"]), tree_leaves(state["params_d"])))
    assert moved_d == d_gate and int(new_state["opt_d"]["count"]) == int(d_gate)


# ---------------------------------------------------------------------------
# the k-means hook, the port's own draws, what is refused
# ---------------------------------------------------------------------------

def test_kmeans_hook_defers_initializes_and_stops(setup):
    """As tests/test_train_steps.py::test_conan_vq_kmeans_hook: a batch with
    fewer prosody rows than codewords defers, the next one initializes the
    codebook (the JAX hook's codebook from the same features), then the hook
    is a no-op."""
    jtask, task, pg_np, _, batch, vq0, vq_init = setup
    state = task.init_state(torch.Generator().manual_seed(0))
    state.update(params_g=params_from_jax(pg_np, "cpu"), vq_state=params_from_jax(vq0, "cpu"))
    tiny = dict(batch, mels=batch["mels"][:1, :32])
    assert task.host_hook(dict(state), 2, tiny) == (None, False)
    new, done = task.host_hook(dict(state), 3, batch)
    assert done and float(new["vq_state"]["initialized"]) == 1.0
    for k in vq_init:
        _close(new["vq_state"][k], vq_init[k], atol=1e-5)
    assert task.host_hook(new, 4, batch) == (None, True)


def test_dropout_draws():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = dropout(x, 0.25, gen)
    assert abs(float((y == 0).float().mean()) - 0.25) < 0.005
    assert torch.all((y == 0) | (y == 1 / 0.75))
    assert dropout(x, 0.25, None) is x and dropout(x, 0.0, gen) is x


def test_window_discriminator_draws():
    """Crop starts uniform in [0, max(len) - w]; Dropout2d drops whole
    channels at rate 0.25."""
    d = MultiWindowDiscriminator((8, 16), 12, 8)
    p = d.init(torch.Generator().manual_seed(1))
    mel = torch.randn(4, 40, 12) + 3.0
    mel[:, 30:] = 0.0                                  # max(len) 30 of T 40
    gen = torch.Generator().manual_seed(2)
    starts, dropped = [[], []], []
    for _ in range(300):
        _, hs, used, fit = d.apply(p, mel, gen)
        assert bool(fit)
        for i, s in enumerate(used):
            starts[i].append(int(s))
        dropped.append((hs[2].abs().sum(dim=(2, 3)) == 0).float().mean())
    for s, w in zip(starts, (8, 16)):
        assert min(s) == 0 and max(s) == 30 - w
    assert abs(float(torch.stack(dropped).mean()) - 0.25) < 0.03
    _, _, used, _ = d.apply(p, mel)
    assert [int(s) for s in used] == [0, 0]


@pytest.mark.parametrize("override", [dict(use_spk_embed=True), dict(train_precision="bf16"),
                                      dict(train_precision="fast"), dict(use_spk_id=True),
                                      dict(accumulate_grad_batches=2)])
def test_unported_options_raise(override):
    """The options once refused are taken now (the speaker-id embedding in
    the generator's tree, a pre-extracted embedding read from the batch,
    accumulation around both optimizers: their steps are held to JAX's in
    tests/test_torch_vocoder_options.py); a train_precision outside
    default/high/highest (the serving ladder's "fast" included) still
    raises ValueError."""
    if "train_precision" in override:
        with pytest.raises(ValueError, match="train_precision"):
            ConanTask(dict(HP, **override), device="cpu")
        return
    task = ConanTask(dict(HP, **override), device="cpu")
    pg = task.init_state(torch.Generator().manual_seed(0))["params_g"]
    assert ("spk_id_proj" in pg) == ("use_spk_id" in override)
    accumulating = isinstance(task.opt_g, PO.Accumulate) and isinstance(task.opt_d, PO.Accumulate)
    assert accumulating == ("accumulate_grad_batches" in override)


def test_soak_r5_config_builds_and_steps_on_cpu():
    """egs/soak_r5/conan.yaml at full width and its shipped rung
    (train_precision default): the task steps on the CPU (one utterance of
    64 frames, the gates at the config's r5 soak values, step 0: before VQ,
    forced, discriminator off)."""
    import os

    from conan_tpu_torch.config import load_config

    hp = load_config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "egs", "soak_r5", "conan.yaml"))
    assert hp["train_precision"] == "default"
    task = ConanTask(hp, device="cpu")
    assert (task.cfg.hidden_size, task.cfg.n_vq, len(task.mel_disc.windows)) == (256, 512, 3)
    rng = np.random.default_rng(14)
    batch = {"content": rng.integers(0, 100, (1, 64)),
             "mels": rng.standard_normal((1, 64, 80)).astype(np.float32),
             "f0": np.full((1, 64), 7.5, np.float32), "uv": np.zeros((1, 64), np.float32)}
    state, metrics = task.train_step(task.init_state(torch.Generator().manual_seed(0)), batch,
                                     torch.Generator().manual_seed(1))
    assert int(state["step"]) == 1 and float(metrics["skipped"]) == 0.0
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert float(metrics["vq_loss"]) == float(metrics["a"]) == float(metrics["d_r"]) == 0.0


def test_task_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ConanTask(HP)
