"""Parameter initializers (``conan_tpu/nn/inits.py``) on explicit
``torch.Generator``s. They give the same distributions as the JAX package's,
not the same numbers: seeded random engines and random-weight smoke runs use
them; trained weights come from checkpoints."""

from __future__ import annotations

import math

import torch


def _fan_in_out(shape: tuple[int, ...]) -> tuple[int, int]:
    # torch convention for conv weights [out, in, *kernel]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    fan_in = shape[1] * receptive if len(shape) > 1 else shape[0]
    return fan_in, shape[0] * receptive


def uniform(gen: torch.Generator, shape, a: float = 0.0, b: float = 1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen) * (b - a) + a


def normal(gen: torch.Generator, shape, mean: float = 0.0, std: float = 1.0) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std + mean


def kaiming_uniform(gen: torch.Generator, shape, a: float = math.sqrt(5)) -> torch.Tensor:
    """torch.nn.Conv1d/Linear default weight init (kaiming_uniform_, a=sqrt(5))."""
    fan_in, _ = _fan_in_out(shape)
    bound = math.sqrt(2.0 / (1 + a * a)) * math.sqrt(3.0 / fan_in)
    return uniform(gen, shape, -bound, bound)


def default_bias(gen: torch.Generator, shape, weight_shape) -> torch.Tensor:
    """torch default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    fan_in, _ = _fan_in_out(weight_shape)
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return uniform(gen, shape, -bound, bound)


def kaiming_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """nn.init.kaiming_normal_ for relu (fan_in mode)."""
    fan_in, _ = _fan_in_out(shape)
    return normal(gen, shape, std=math.sqrt(2.0) / math.sqrt(fan_in))


def xavier_uniform(gen: torch.Generator, shape, gain: float = 1.0) -> torch.Tensor:
    fan_in, fan_out = _fan_in_out(shape)
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(gen, shape, -bound, bound)


def fan_in_redraw(tree, gen: torch.Generator):
    """``tree`` with each float leaf redrawn: leaves of two or more dims
    N(0, 1/fan_in) (fan-in over all dims but the first), vectors N(0, 0.01).
    For random-weight smoke runs of a vocoder: its own init (weight norm's v
    ~ N(0, 0.01)) leaves the wav at its bias DC, which no chunking can
    change; these weights keep its signal at the order of its input."""
    from conan_tpu_torch.checkpoint import tree_map

    def leaf(x):
        if not torch.is_tensor(x) or not x.is_floating_point():
            return x
        if x.dim() >= 2:
            return torch.randn(x.shape, generator=gen) / math.sqrt(math.prod(x.shape[1:]))
        return 0.1 * torch.randn(x.shape, generator=gen)

    return tree_map(leaf, tree)
