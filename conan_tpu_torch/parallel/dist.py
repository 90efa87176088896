"""Data parallelism over CUDA cards (``conan_tpu/parallel/mesh.py``).

The JAX trainer jits its step over a mesh of every device: the batch is
padded by repeating leading rows, split into contiguous blocks, one per
device, and XLA all-reduces whatever the one-device step would have summed.
The port runs one process per card (``torch.distributed``, NCCL on CUDA,
gloo on the CPU) with the same contract: rank r holds block r of the padded
global batch, and the step on N ranks is the step on that whole batch.

  World                  rank, size, device and process group; None means
                         alone, and then every helper here is the identity
                         and launches no collective
  init_distributed       joins the group ``torchrun`` describes
                         (``initialize_multihost``)
  pad_batch_to_multiple  the wrap-around repeat of leading rows
  local_rows             this rank's contiguous block (``shard_batch``)
  broadcast_state        rank 0's tree on every rank (``replicate``)
  all_reduce_grads       one flattened buffer per dtype, SUM

Inside a step the world is *active* (``scope``): the batch reductions and
the random draws of the losses and models read it from there, so nothing
between the task and the leaf functions takes a world argument.

  - A loss that reduces over the batch returns this rank's share of the
    global batch's loss: a plain mean is the local mean / size (every rank
    holds as many rows of one shape), a masked mean divides the local sum by
    the mask count summed over the ranks (``global_count``). The shares sum
    to the global loss, so the SUM of the ranks' gradients is its gradient.
  - A statistic that enters the forward nonlinearly (the discriminators'
    batch norm, the STFT loss's spectral convergence) is summed with
    ``sum_across``, an all-reduce whose backward all-reduces the gradient.
  - A random draw with one row per batch row is made at the global batch's
    shape from the shared generator, and the rank keeps its rows
    (``rand``, ``randn``, ``randint``): every rank's generator advances
    alike and each row gets the draw it gets on one rank.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from conan_tpu_torch.checkpoint import tree_leaves, tree_unflatten
from conan_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class World:
    """One rank's view of the group: ``rank`` of ``size``, its ``device``
    and the process ``group`` (None: the default group)."""

    rank: int
    size: int
    device: torch.device
    group: object = None

    def block(self, n_local: int) -> slice:
        """Rows [rank · n_local, (rank + 1) · n_local) of the global batch."""
        return slice(self.rank * n_local, (self.rank + 1) * n_local)


def init_distributed(device: str | torch.device | None = None, *, backend: str | None = None,
                     init_method: str = "env://", rank: int | None = None,
                     world_size: int | None = None,
                     timeout: datetime.timedelta | None = None) -> World:
    """Join the process group and return this rank's World.

    ``rank`` and ``world_size`` default to ``torchrun``'s ``RANK`` and
    ``WORLD_SIZE``; ``device`` to ``cuda:LOCAL_RANK``; the backend to NCCL on
    CUDA and gloo on the CPU; ``init_method`` to ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``). A failure to join raises."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)
    return World(rank, world_size, device, dist.group.WORLD)


def shutdown(world: World | None) -> None:
    if world is not None and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------- batches
def _is_rows(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1


def pad_batch_to_multiple(batch: dict, n: int) -> dict:
    """Repeat leading rows so that every [B, ...] array has B % n == 0:
    rows [0, B) then rows 0, 1, ... again (the reference's pad-to-multiple
    of the batch list). Other entries pass unchanged."""
    out = {}
    for k, v in batch.items():
        if _is_rows(v) and v.shape[0] % n:
            idx = np.arange(v.shape[0] + (-v.shape[0]) % n) % v.shape[0]
            v = v[torch.from_numpy(idx) if isinstance(v, torch.Tensor) else idx]
        out[k] = v
    return out


def local_rows(batch: dict, world: World | None) -> dict:
    """This rank's contiguous block of the padded global batch (the rows
    JAX's ``P("data")`` places on device ``rank``); the batch itself when
    alone."""
    if world is None:
        return batch
    padded = pad_batch_to_multiple(batch, world.size)
    return {k: v[world.block(v.shape[0] // world.size)] if _is_rows(v) else v
            for k, v in padded.items()}


# ---------------------------------------------------------------- state
def _flat_by_dtype(tensors: list[torch.Tensor]):
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _collective_on_buffers(tensors: list[torch.Tensor], world: World, op) -> list:
    """Apply ``op(buffer)`` in place to one flat buffer per dtype of
    ``tensors`` (on the world's device) and return the tensors cut back out
    of it, each on its own device and in its own shape."""
    out: list = [None] * len(tensors)
    for dtype, idx in _flat_by_dtype(tensors).items():
        parts = [tensors[i].detach().reshape(-1).to(world.device) for i in idx]
        buf = torch.cat(parts) if parts else torch.empty(0, dtype=dtype, device=world.device)
        op(buf)
        for i, chunk in zip(idx, buf.split([p.numel() for p in parts])):
            out[i] = chunk.reshape(tensors[i].shape).to(tensors[i].device)
    return out


def sorted_keys(tree):
    """The tree with every dict's keys in sorted order: one leaf order for
    trees that hold the same keys in other orders. A subtree already in
    that order is returned as it is, not copied."""
    if isinstance(tree, dict):
        out = {k: sorted_keys(tree[k]) for k in sorted(tree)}
        same = list(out) == list(tree) and all(out[k] is tree[k] for k in out)
        return tree if same else out
    if isinstance(tree, (list, tuple)):
        out = [sorted_keys(v) for v in tree]
        return tree if all(a is b for a, b in zip(out, tree)) else type(tree)(out)
    return tree


def broadcast_state(tree, world: World | None):
    """Rank 0's tree on every rank (``replicate``): every tensor leaf is
    replaced by rank 0's value, one broadcast per dtype. The leaves are laid
    out in the order of the sorted key paths, so ranks whose trees hold the
    same keys in another order (a checkpoint's, an init's) agree; the tree
    comes back with its keys sorted. Leaves that are not tensors (None)
    stay."""
    if world is None:
        return tree
    tree = sorted_keys(tree)
    leaves = tree_leaves(tree)
    idx = [i for i, x in enumerate(leaves) if torch.is_tensor(x)]
    got = _collective_on_buffers([leaves[i] for i in idx], world,
                                 lambda b: dist.broadcast(b, src=0, group=world.group))
    leaves = list(leaves)
    for i, t in zip(idx, got):
        leaves[i] = t
    return tree_unflatten(tree, leaves)


def all_reduce_grads(grads: list[torch.Tensor], world: World | None) -> list[torch.Tensor]:
    """The SUM over the ranks of each gradient, one flattened buffer per
    dtype: with losses that are the ranks' shares of the global loss, the
    global batch's gradient."""
    if world is None:
        return list(grads)
    return _collective_on_buffers(list(grads), world,
                                  lambda b: dist.all_reduce(b, group=world.group))


def reduce_metrics(shares: dict, world: World | None) -> dict:
    """Each metric summed over the ranks in one all-reduce: the global
    batch's value of metrics given as the ranks' shares."""
    if world is None or not shares:
        return shares
    keys = list(shares)
    buf = torch.stack([torch.as_tensor(shares[k], device=world.device).detach().float()
                       for k in keys])
    dist.all_reduce(buf, group=world.group)
    return dict(zip(keys, buf.unbind()))


def barrier(world: World | None) -> None:
    if world is not None:
        if world.device.type == "cuda" and dist.get_backend(world.group) == "nccl":
            dist.barrier(group=world.group, device_ids=[world.device.index])
        else:
            dist.barrier(group=world.group)


def all_gather_rows(x: torch.Tensor, world: World | None) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all), concatenated in rank order on
    dim 0: the global batch's rows. No gradient."""
    if world is None:
        return x
    parts = [torch.empty_like(x) for _ in range(world.size)]
    dist.all_gather(parts, x.detach().contiguous(), group=world.group)
    return torch.cat(parts)


# ---------------------------------------------------------------- the step's scope
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("conan_tpu_torch_world",
                                                        default=None)


@contextlib.contextmanager
def scope(world: World | None):
    """Make ``world`` the active one for the reductions and draws below.
    Each helper computes one formula whatever the world's size; for a world
    of one rank every collective is the identity (a sum of one value, a
    division by 1, a draw of B × 1 rows cut to B), so its step is the step
    alone, bit for bit."""
    token = _ACTIVE.set(world)
    try:
        yield world
    finally:
        _ACTIVE.reset(token)


def active() -> World | None:
    return _ACTIVE.get()


def size() -> int:
    """The active world's number of ranks; 1 when alone."""
    w = active()
    return 1 if w is None else w.size


def global_count(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active world's ranks (a count or a sum that
    takes no gradient); ``x`` itself when alone."""
    w = active()
    if w is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=w.group)
    return y


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The max of ``x`` over the active world's ranks (no gradient)."""
    w = active()
    if w is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=w.group)
    return y


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_across(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active world's ranks, with the gradient: its
    backward sums the ranks' gradients, so each rank's input gets the
    gradient of the global loss (the ranks' shares summed). ``x`` when
    alone."""
    w = active()
    return x if w is None else _SumAcross.apply(x, w.group)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch."""
    w = active()
    return torch.mean(x) if w is None else torch.mean(x) / w.size


def global_share(value: torch.Tensor) -> torch.Tensor:
    """A value computed from global sums (the same on every rank) as this
    rank's share of it: value / size."""
    w = active()
    return value if w is None else value / w.size


def _rows(shape, draw):
    w = active()
    shape = tuple(shape)
    if w is None or not shape:
        return draw(shape)
    return draw((shape[0] * w.size, *shape[1:]))[w.block(shape[0])]


def rand(shape, generator: torch.Generator | None, device=None) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's rows of the global batch: drawn
    at the global shape (dim 0 × size) and cut to the rank's block."""
    return _rows(shape, lambda s: torch.rand(s, generator=generator, device=device))


def randn(shape, generator: torch.Generator | None, device=None) -> torch.Tensor:
    """``torch.randn`` as ``rand`` draws."""
    return _rows(shape, lambda s: torch.randn(s, generator=generator, device=device))


def randint(low: int, high: int, shape, generator: torch.Generator | None,
            device=None) -> torch.Tensor:
    """``torch.randint`` as ``rand`` draws."""
    return _rows(shape, lambda s: torch.randint(low, high, s, generator=generator,
                                                device=device))


def roll_rows(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll(x, shift, dims=0)`` over the global batch, this rank's
    rows of it (no gradient crosses ranks)."""
    w = active()
    if w is None:
        return torch.roll(x, shift, dims=0)
    return torch.roll(all_gather_rows(x, w), shift, dims=0)[w.block(x.shape[0])]
