"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Parameters: the tree and shapes come from the JAX package's own ``init``,
traced with ``jax.eval_shape`` (nothing is compiled), and the values from a
seeded numpy generator. Compiling the JAX inits themselves would cost more
CPU time than the tests themselves; both packages get the same numbers either
way.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import types

import jax
import numpy as np
import pytest
import torch

from conan_tpu.infer.streaming import StreamingConfig
from conan_tpu.models.conan.model import ConanConfig
from conan_tpu.models.emformer import EmformerConfig
from conan_tpu.models.vocoder.hifigan import HifiGanConfig

import conan_tpu_torch.infer.streaming as port_streaming
from conan_tpu_torch.audio.mel import MelConfig as PortMelConfig
from conan_tpu_torch.models.conan.model import ConanConfig as PortConanConfig
from conan_tpu_torch.models.emformer import EmformerConfig as PortEmformerConfig
from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig as PortHifiGanConfig

# TensorBoard's writer reaches TensorFlow, where it is installed, through
# ``tensorboard.compat.tf``, which takes TensorBoard's own stub instead where
# ``tensorboard.compat.notf`` imports. The port's trainer writes TensorBoard
# where it can; in the tests it writes the same event files through the stub
# and no process imports TensorFlow (tens of seconds each).
sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))

# the SMALL engine of tests/test_streaming_engine.py
SMALL = StreamingConfig(
    emformer=EmformerConfig(input_dim=80, num_heads=4, ffn_dim=64, num_layers=2,
                            segment_length=4, left_context_length=8,
                            right_context_length=2, output_dim=100),
    conan=ConanConfig(hidden_size=64),
    vocoder=HifiGanConfig(upsample_initial_channel=32),
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one intra-op thread for a module's tests (autouse where a
    test module imports it). The suite runs its files in parallel workers,
    each of which would otherwise start an OpenMP pool as wide as the
    machine; six such pools on eight cores made small PyTorch ops on the CPU
    one to two orders of magnitude slower than in a lone process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_params(init_fn, seed: int):
    """Random parameters in the tree of the JAX ``init_fn(key)``: weights
    N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.01), other vectors N(0, 0.01)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if not np.issubdtype(s.dtype, np.floating):
            return np.zeros(s.shape, s.dtype)
        if len(s.shape) >= 2:
            fan_in = math.prod(s.shape[1:])
            return (rng.standard_normal(s.shape) / math.sqrt(fan_in)).astype(np.float32)
        x = (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return x + 1.0 if getattr(path[-1], "key", None) == "scale" else x

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init_fn, jax.random.PRNGKey(0)))


def refill_checkpoint_params(work_dir: str, key: str, seed: int) -> None:
    """Rewrite the ``key`` subtree of ``work_dir``'s last checkpoint with
    numpy_params' draws (weights N(0, 1/fan_in), LayerNorm scales 1 + N(0,
    0.01), other vectors N(0, 0.01)) in the same tree and shapes; integer
    leaves are kept. The models' own random inits (weight-normed v ~ N(0,
    0.01), torch's default biases) shrink a mel's part of a small vocoder's
    wav to ~1e-7 under its bias DC; these weights keep each stage's signal
    at the order of its input."""
    from conan_tpu_torch.checkpoint import get_last_checkpoint, save_checkpoint

    ckpt, _ = get_last_checkpoint(work_dir)
    rng = np.random.default_rng(seed)

    def fill(tree, name=""):
        if isinstance(tree, dict):
            return {k: fill(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v) for v in tree)
        a = np.asarray(tree)
        if a.dtype.kind != "f":
            return tree
        if a.ndim >= 2:
            fan_in = math.prod(a.shape[1:])
            return (rng.standard_normal(a.shape) / math.sqrt(fan_in)).astype(a.dtype)
        x = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return x + 1 if name == "scale" else x

    state = dict(ckpt["state"], **{key: fill(ckpt["state"][key])})
    save_checkpoint(work_dir, ckpt["global_step"], state, ckpt["hparams"])


def port_config(cfg: StreamingConfig) -> port_streaming.StreamingConfig:
    """The port's StreamingConfig with the same fields as a JAX one."""
    a = dataclasses.asdict
    return port_streaming.StreamingConfig(
        mel=PortMelConfig(**a(cfg.mel)), emformer=PortEmformerConfig(**a(cfg.emformer)),
        conan=PortConanConfig(**a(cfg.conan)), vocoder=PortHifiGanConfig(**a(cfg.vocoder)))


def leaf_paths(tree, prefix: str = "") -> set[str]:
    if isinstance(tree, dict):
        return set().union(*[leaf_paths(v, f"{prefix}/{k}") for k, v in tree.items()])
    if isinstance(tree, (list, tuple)):
        return set().union(*[leaf_paths(v, f"{prefix}/{i}") for i, v in enumerate(tree)])
    return {prefix}


def leaf_shapes(tree, prefix: str = "") -> dict[str, tuple]:
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items() for p, s in leaf_shapes(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: s for i, v in enumerate(tree)
                for p, s in leaf_shapes(v, f"{prefix}/{i}").items()}
    return {prefix: tuple(tree.shape)}


def jax_conan_step_fns(jtask):
    """JAX's ConanTask generator and discriminator losses with their
    gradients, jitted, with the step's random parts fixed as the port's step
    runs them without a generator: dropout off (``rng=None`` into the model)
    and every mel-discriminator crop at frame 0. The two ``apply`` methods
    are wrapped on this task instance only; nothing in the package changes.
    Returns (gen, disc): ``gen(pg, pd, vq_state, batch, step, key, None,
    use_random_ref)`` and ``disc(pd, mels, mel_p, key)``, each →
    ((loss, aux), grads)."""
    model_apply, disc_apply = jtask.model.apply, jtask.mel_disc.apply
    jtask.model.apply = lambda *a, **k: model_apply(*a, **{**k, "rng": None})
    jtask.mel_disc.apply = lambda pd, mel, rng, train=False, start_frames=None: disc_apply(
        pd, mel, rng, train=False, start_frames=[0] * len(jtask.mel_disc.windows))
    gen = jax.jit(jax.value_and_grad(jtask._gen_losses, has_aux=True), static_argnums=(6, 7))
    disc = jax.jit(jax.value_and_grad(jtask._disc_losses, has_aux=True))
    return gen, disc
