"""The port's Emformer distillation training (the CE and accuracy, the LR
schedule, the offline forward with its gradients, the device-built mask,
three EmformerTask steps) against the JAX package's, on the CPU.

Sizes: 2 layers, input 16, 2 heads, FFN 32, segment 4, left context 8,
right context 2, 10 codes; B = 2 of 6 segments. Parameter trees come from
``jax.eval_shape`` of the JAX init and their values from numpy.

Tolerances, as tests/test_torch_vocoder_train.py's (fp32 on both sides,
sums in other orders): values atol 1e-4 / rtol 1e-4; gradients a relative
L2 error of 1e-3 per leaf; parameters and optimizer state after a step
atol 1e-6 against JAX's optimizer update and NaN guard applied to the
port's own gradients, and against JAX's whole step a relative L2 error of
2e-2 over each leaf's update (a first Adam update is ±lr wherever |g| >>
eps, so an entry whose gradient is within fp32 rounding of zero can take
the other sign; the key half of kv's bias, whose exact gradient is zero,
is left out of that comparison alone).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_tpu.models.emformer import EmformerConfig as JEmformerConfig
from conan_tpu.models.emformer import EmformerDistillModel as JEmformerDistillModel
from conan_tpu.train import losses as JL
from conan_tpu.train import optim as joptim
from conan_tpu.train import tasks as jtasks
from conan_tpu.train.tasks import EmformerTask as JEmformerTask

from conan_tpu_torch.checkpoint import params_from_jax, tree_leaves, tree_to_numpy
from conan_tpu_torch.models.emformer import EmformerConfig, EmformerDistillModel
from conan_tpu_torch.train import losses as PL
from conan_tpu_torch.train import optim as poptim
from conan_tpu_torch.train.tasks import EmformerTask, _grads, _with_grad

from tests.torch_port_util import leaf_paths, numpy_params
from tests.torch_port_util import one_torch_thread  # noqa: F401

SMALL = dict(input_dim=16, num_heads=2, ffn_dim=32, num_layers=2, segment_length=4,
             left_context_length=8, right_context_length=2, output_dim=10)
HP = {"emformer_input_dim": 16, "emformer_layers": 2, "chunk_size": 80, "right_context": 2,
      "emformer_output_dim": 10, "lr": 1e-3, "warmup_steps": 2, "warmup_init_lr": 1e-4,
      "lr_decay": 0.9, "decay_interval": 1, "min_lr": 1e-6, "optimizer_adam_beta1": 0.9,
      "optimizer_adam_beta2": 0.98, "weight_decay": 0.0, "clip_grad_norm": 1.0,
      "distillation_temperature": 1.5, "lambda_distillation": 0.7,
      "train_precision": "highest"}
B, N_SEGS, SEG, RC = 2, 6, 4, 2


def _close(got, want, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _by_path(tree, prefix: str = "") -> dict:
    """{key path: numpy leaf}, the same for a JAX tree and the port's."""
    if isinstance(tree, dict):
        return {p: v for k, x in tree.items() for p, v in _by_path(x, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _by_path(x, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree.detach() if torch.is_tensor(tree) else tree)}


def _batch(seed: int) -> dict:
    """mels [B, N_SEGS·SEG + RC, 16], codes [B, N_SEGS·SEG] with -1 tails."""
    rng = np.random.default_rng(seed)
    T = N_SEGS * SEG
    codes = rng.integers(0, 10, (B, T))
    codes[0, T - RC:] = -1
    codes[1, T - 7:] = -1
    return {"mels": rng.standard_normal((B, T + RC, 16)).astype(np.float32), "content": codes}


@pytest.fixture(scope="module")
def models():
    jmodel = JEmformerDistillModel(JEmformerConfig(**SMALL))
    return jmodel, EmformerDistillModel(EmformerConfig(**SMALL)), numpy_params(jmodel.init, 1)


@pytest.mark.parametrize("temperature", [1.0, 0.6])
def test_distillation_loss_and_accuracy_match_jax(temperature):
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((2, 12, 10))).astype(np.float32)
    codes = rng.integers(0, 10, (2, 12))
    codes[0, 9:] = -1
    codes[1, :3] = -1
    codes[1, 5] = int(np.argmax(logits[1, 5]))      # at least one hit
    mask = codes != -1
    _close(PL.distillation_loss(torch.from_numpy(logits), torch.from_numpy(codes),
                                torch.from_numpy(mask), temperature),
           JL.distillation_loss(logits, codes, mask, temperature), atol=0)
    acc = PL.distillation_accuracy(torch.from_numpy(logits), torch.from_numpy(codes),
                                   torch.from_numpy(mask))
    _close(acc, JL.distillation_accuracy(logits, codes, mask), atol=0, rtol=1e-6)
    assert 0 < float(acc) < 1
    none = np.zeros_like(mask)                     # no valid code: 0, not NaN
    assert float(PL.distillation_loss(torch.from_numpy(logits), torch.from_numpy(codes),
                                      torch.from_numpy(none))) == 0.0


def test_emformer_distill_schedule_matches_jax():
    args = (1e-3, 10, 1e-6, 0.5, 3, 4e-5)
    steps = np.arange(0, 40, dtype=np.int32)
    got = poptim.emformer_distill_schedule(*args)(torch.from_numpy(steps))
    want = joptim.emformer_distill_schedule(*args)(jnp.asarray(steps))
    _close(got, want, atol=0, rtol=1e-6)
    assert float(got[0]) == pytest.approx(1e-6) and float(got[10]) == pytest.approx(1e-3)
    assert float(got[-1]) == pytest.approx(4e-5)                    # at min_lr


@pytest.mark.parametrize("lengths", [None, [26, 19]])
def test_emformer_apply_and_grads_match_jax(models, lengths):
    """The port's dense forward against JAX's banded (default) and dense
    paths: values, and the gradient of a weighted sum of the output with
    respect to every parameter."""
    jmodel, model, p_np = models
    batch = _batch(3)
    w = np.random.default_rng(4).standard_normal((B, N_SEGS * SEG, 16)).astype(np.float32)
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.tensor(lengths)
    p = _with_grad(params_from_jax(p_np, "cpu"))
    out = model.emformer.apply(p, torch.from_numpy(batch["mels"]), tl)
    grads = _grads(torch.sum(out * torch.from_numpy(w)), p)
    got_grads = _by_path(tree_to_numpy(dict(zip(range(len(grads)), grads))))
    paths = sorted(leaf_paths(p_np))
    assert len(paths) == len(grads)
    for banded in (True, False):
        def f(params):
            o = jmodel.emformer.apply(params, jnp.asarray(batch["mels"]), jl, banded=banded)
            return jnp.sum(o * w), o

        (_, want), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(p_np)
        _close(out.detach(), want)
        want_grads = _by_path(jgrads)
        port_paths = _port_leaf_paths(p)
        for i, path in enumerate(port_paths):
            if path.startswith("/proj"):          # not reached by the Emformer's output
                continue
            assert _rel_l2(got_grads[f"/{i}"], want_grads[path]) < 1e-3, (banded, path)


def _port_leaf_paths(tree, prefix: str = "") -> list[str]:
    """Key paths in ``tree_leaves``'s order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _port_leaf_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _port_leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


@pytest.mark.parametrize("geometry", [(4, 2, 8), (4, 0, 8), (3, 1, 5)])
def test_device_mask_matches_numpy(geometry):
    seg, rc, L = geometry
    kw = dict(SMALL, segment_length=seg, right_context_length=rc, left_context_length=L)
    jemf = JEmformerDistillModel(JEmformerConfig(**kw)).emformer
    emf = EmformerDistillModel(EmformerConfig(**kw)).emformer
    for n_segs in (1, 5, 17):
        got = emf.offline_mask(n_segs, "cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), jemf._offline_mask(n_segs))
        assert emf.offline_mask(n_segs, torch.device("cpu")) is got          # cached


def _jax_state(state: dict, jtask) -> dict:
    """The port's state in JAX's layout: its {count, mu, nu} into optax's
    (clip, ScaleByAdamState, ScaleByScheduleState) chain state."""
    st = tree_to_numpy(state)
    clip, adam, sched = jtask.opt.init(st["params"])
    count = st["opt"]["count"]
    return {"params": st["params"], "step": st["step"],
            "opt": (clip, adam._replace(count=count, mu=st["opt"]["mu"], nu=st["opt"]["nu"]),
                    sched._replace(count=count))}


def _port_opt(jopt) -> dict:
    """optax's chain state as the port's {count, mu, nu}."""
    adam, sched = jopt[1], jopt[2]
    assert int(adam.count) == int(sched.count)
    return {"count": adam.count, "mu": adam.mu, "nu": adam.nu}


def _tasks(p_np):
    jtask, task = JEmformerTask(HP), EmformerTask(HP, device="cpu")
    jtask.model = JEmformerDistillModel(JEmformerConfig(**SMALL))
    task.model = EmformerDistillModel(EmformerConfig(**SMALL))
    return jtask, task


def test_emformer_task_steps_match_jax(models):
    """Three steps from one state, each from the port's state so far: the
    third batch holds a NaN, so both packages skip it and keep their
    parameters and optimizer state."""
    _, _, p_np = models
    jtask, task = _tasks(p_np)
    jgrad = jax.jit(jax.value_and_grad(jtask._loss, has_aux=True))

    @jax.jit
    def jupdate(grads, opt, params):
        upd, opt_new = jtask.opt.update(grads, opt, params)
        return jtasks._gated_update(jtasks._tree_finite(grads), params, upd, opt_new, opt)

    jstep = jax.jit(jtask.train_step)
    params = params_from_jax(p_np, "cpu")
    state = {"params": params, "opt": task.opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    batches = [_batch(10), _batch(11), _batch(12)]
    batches[2]["mels"][1, 5, 3] = np.nan
    for i, batch in enumerate(batches):
        jstate = _jax_state(state, jtask)
        new, metrics = task.train_step(state, batch)
        (jloss, jacc), jg = jgrad(jstate["params"], batch)
        (want_p, want_opt) = jupdate(jg, jstate["opt"], jstate["params"])
        jnew, jmetrics = jstep(jstate, batch)
        for k in ("ce", "acc", "skipped"):
            _close(metrics[k], jmetrics[k], atol=0)
        _close(metrics["ce"], jloss, atol=0)
        assert float(metrics["skipped"]) == (1.0 if i == 2 else 0.0)
        # the port's gradients: its first moments over (1 - b1), from step 0
        p = _with_grad(state["params"])
        got_g = _grads(task._loss(p, batch)[0], p)
        paths = _port_leaf_paths(p)
        want_g = _by_path(jg)
        if i < 2:
            for path, g in zip(paths, got_g):
                assert _rel_l2(g, want_g[path]) < 1e-3, (i, path)
        # JAX's update on the port's own gradients
        pg = {path: np.asarray(g) for path, g in zip(paths, got_g)}
        grads_tree = jax.tree_util.tree_map_with_path(
            lambda kp, x: pg["/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                              for k in kp)], jstate["params"])
        ref_p, ref_opt = jupdate(grads_tree, jstate["opt"], jstate["params"])
        got_p, got_opt = _by_path(new["params"]), _by_path(new["opt"])
        for path, want in _by_path(ref_p).items():
            _close(got_p[path], want, atol=1e-6, rtol=0)
        for path, want in _by_path(_port_opt(ref_opt)).items():
            _close(got_opt[path], want, atol=1e-6, rtol=0)
        old = _by_path(state["params"])
        for path, want in _by_path(jnew["params"]).items():
            if i == 2:
                np.testing.assert_array_equal(got_p[path], old[path])
                np.testing.assert_array_equal(want, old[path])
                continue
            # the key half of kv's bias adds q·b_k to every key of a query
            # alike, which the softmax cancels: its exact gradient is 0, so
            # each package's update there is ±lr by the sign of its rounding
            cut = slice(SMALL["input_dim"], None) if path.endswith("/kv/b") else slice(None)
            assert _rel_l2((got_p[path] - old[path])[cut], (want - old[path])[cut]) < 2e-2, \
                (i, path)
        assert int(new["step"]) == int(jnew["step"]) == i + 1
        assert int(new["opt"]["count"]) == int(_port_opt(jnew["opt"])["count"]) == min(i + 1, 2)
        state = new
    assert len(tree_leaves(state["opt"]["mu"])) == len(leaf_paths(p_np))

