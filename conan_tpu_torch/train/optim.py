"""AdamW and the LR schedules, in optax's semantics
(``conan_tpu/train/optim.py``: ``clip_by_global_norm`` → ``scale_by_adam`` →
``add_decayed_weights`` → ``scale_by_learning_rate``), and gradient
accumulation around it (``Accumulate``, ``optax.MultiSteps``).

Functional, over parameter trees of tensors (nested dicts and lists): the
state is ``{"count", "mu", "nu"}``, all tensors on the parameters' device,
and ``update`` returns the additive updates and the new state. Nothing is
modified in place and, but for ``Accumulate``'s mini-step count, nothing is
read back to the host, so a step can be kept or dropped whole on the device
(the train step's NaN guard). A schedule is a
function of the count tensor of updates made before this one.
"""

from __future__ import annotations

import torch

from conan_tpu_torch.checkpoint import tree_leaves, tree_map, tree_unflatten


def none_schedule(lr: float):
    return lambda step: torch.full_like(step, lr, dtype=torch.float32)


def warmup_schedule(lr: float, warmup_updates: int = 4000):
    """max(lr · min(step / warmup, 1), 1e-7)."""
    return lambda step: torch.clamp(lr * torch.clamp(step / warmup_updates, max=1.0), min=1e-7)


def rsqrt_schedule(lr: float, warmup_updates: int, hidden_size: int):
    """The Transformer schedule: linear warmup, then lr · step^-0.5 ·
    hidden^-0.5 (max(step, warmup)^-0.5 during the warmup), at least 1e-7."""
    def f(step):
        warm = torch.clamp(step / warmup_updates, max=1.0)
        decay = torch.clamp(step.float(), min=float(warmup_updates)) ** -0.5
        return torch.clamp(lr * warm * decay * hidden_size ** -0.5, min=1e-7)
    return f


def step_lr_schedule(lr: float, step_size: int, gamma: float):
    """torch StepLR: lr · gamma^floor(step / step_size), of a count tensor."""
    return lambda step: lr * gamma ** torch.floor(step / step_size)


def emformer_distill_schedule(lr: float, warmup_steps: int = 20000,
                              warmup_init_lr: float = 1e-7, lr_decay: float = 0.995,
                              decay_interval: int = 2500, min_lr: float = 1e-6):
    """The Emformer distillation's LambdaLR (tasks/Emformer/Emformer.py:474-491):
    linear from ``warmup_init_lr`` to ``lr`` over ``warmup_steps``, then
    lr · lr_decay^floor((step - warmup) / decay_interval), at least ``min_lr``."""
    def f(step):
        warm = warmup_init_lr + (lr - warmup_init_lr) * (step / warmup_steps)
        n_decays = torch.floor(torch.clamp(step - warmup_steps, min=0) / decay_interval)
        decayed = torch.clamp(lr * lr_decay ** n_decays, min=min_lr)
        return torch.where(step < warmup_steps, warm, decayed)
    return f


def build_schedule(hp):
    """The generator's schedule named by ``hp["scheduler"]`` (none, warmup,
    rsqrt, step_lr), as tasks/tts/speech_base.py:156-165 selects it."""
    name = hp.get("scheduler", "none")
    if name == "rsqrt":
        return rsqrt_schedule(hp["lr"], hp.get("warmup_updates", 4000), hp["hidden_size"])
    if name == "warmup":
        return warmup_schedule(hp["lr"], hp.get("warmup_updates", 4000))
    if name == "step_lr":
        return step_lr_schedule(hp["lr"], 500, 0.998)
    return none_schedule(hp["lr"])


class AdamW:
    """Global-norm clipping (when ``clip_norm`` > 0), then Adam with bias
    correction and eps outside the sqrt, then ``weight_decay`` · params added
    (decoupled, so it is scaled by the learning rate too), then −lr(count)."""

    def __init__(self, schedule, *, b1: float = 0.9, b2: float = 0.98, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip_norm: float = 0.0):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.clip_norm = weight_decay, clip_norm

    def init(self, params) -> dict:
        device = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads, state: dict, params=None):
        """``params`` (the tree the gradients are of) is needed only with
        weight decay."""
        g = tree_leaves(grads)
        if self.clip_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(x)
                                                         for x in g]))
            g = [torch.where(norm < self.clip_norm, x, x / norm * self.clip_norm) for x in g]
        count = state["count"] + 1
        mu = [self.b1 * m + (1 - self.b1) * x for m, x in zip(tree_leaves(state["mu"]), g)]
        nu = [self.b2 * n + (1 - self.b2) * x * x for n, x in zip(tree_leaves(state["nu"]), g)]
        c1, c2 = 1 - self.b1 ** count, 1 - self.b2 ** count
        updates = [(m / c1) / (torch.sqrt(n / c2) + self.eps) for m, n in zip(mu, nu)]
        if self.weight_decay:
            updates = [u + self.weight_decay * p for u, p in zip(updates, tree_leaves(params))]
        lr = self.schedule(state["count"])
        updates = [-lr * u for u in updates]
        return tree_unflatten(grads, updates), {"count": count,
                                                "mu": tree_unflatten(grads, mu),
                                                "nu": tree_unflatten(grads, nu)}


class Accumulate:
    """``optax.MultiSteps(inner, every_k_schedule=k)`` with its defaults (the
    mean of the gradients, no skip function): the reference's
    ``accumulate_grad_batches`` (trainer.py:339,366).

    The state is ``{"mini_step", "gradient_step", "inner", "acc"}``: the
    mini-steps taken since the last update, the updates made, the inner
    optimizer's state and the running mean of this round's gradients
    (Welford: acc + (g - acc) / (mini_step + 1)). On the k-th mini-step
    (mini_step = k - 1) the inner update runs on the mean, its updates and
    state are kept and the mean is reset to zero; on the others the updates
    are zero and the inner state stays. So the inner clip sees the mean, and
    the inner count, which the schedule reads, counts updates, not
    mini-steps. ``mini_step`` is read back to the host once a mini-step to
    choose the branch, as optax's ``lax.cond`` chooses it on the device:
    running the inner chain on every mini-step and keeping it on the k-th
    cost 151 ms of launches a mini-step of the shipped vocoder with every
    option on, on an H100 (chip_smoke.py's vocoder_options phase). A caller
    that drops the whole new state (the NaN guard) drops the mini-step with
    it, as if it never happened."""

    def __init__(self, inner: AdamW, every_k: int):
        self.inner, self.k = inner, every_k

    def init(self, params) -> dict:
        inner = self.inner.init(params)
        return {"mini_step": torch.zeros_like(inner["count"]),
                "gradient_step": torch.zeros_like(inner["count"]), "inner": inner,
                "acc": tree_map(torch.zeros_like, params)}

    def update(self, grads, state: dict, params=None):
        n = state["mini_step"]
        acc = [a + (g - a) / (n + 1) for a, g in zip(tree_leaves(state["acc"]),
                                                    tree_leaves(grads))]
        if int(n) != self.k - 1:
            return (tree_map(torch.zeros_like, grads),
                    {"mini_step": n + 1, "gradient_step": state["gradient_step"],
                     "inner": state["inner"], "acc": tree_unflatten(grads, acc)})
        updates, inner = self.inner.update(tree_unflatten(grads, acc), state["inner"], params)
        return updates, {"mini_step": torch.zeros_like(n),
                         "gradient_step": state["gradient_step"] + 1, "inner": inner,
                         "acc": tree_map(torch.zeros_like, grads)}


def accumulating(inner: AdamW, every_k: int):
    """``inner`` itself for ``every_k`` ≤ 1, else wrapped in ``Accumulate``,
    as the JAX package's ``adamw(accumulate_steps=...)`` builds it."""
    return Accumulate(inner, every_k) if every_k and every_k > 1 else inner
