"""Checkpoint I/O in the JAX package's format (``conan_tpu/train/checkpoint.py``).

A checkpoint is one pickle of ``{"global_step", "state": tree of numpy arrays,
"hparams": dict}`` named ``model_ckpt_steps_<N>.ckpt``. The tree is nested
dicts and lists; its key paths are the contract both packages share, so
``params_from_jax`` only turns leaves into tensors and keeps every key.

The original system's PyTorch checkpoints are flat state dicts named by
module path. A model maps one through a *name tree*: its parameter tree with
the state-dict key at each leaf. ``params_from_state_dict`` reads a state
dict through it, ``state_dict_from_params`` writes a tree back under the
same keys, so each mapping is written once and serves both ways.
"""

from __future__ import annotations

import glob
import os
import pickle
import re

import numpy as np
import torch

from conan_tpu_torch.device import resolve_device


def get_all_checkpoints(work_dir: str, prefix: str = "model_ckpt_steps") -> list[str]:
    """Newest first."""
    paths = glob.glob(os.path.join(work_dir, f"{prefix}_*.ckpt"))
    return sorted(paths, key=lambda p: -int(re.findall(r"_(\d+)\.ckpt", p)[0]))


def get_last_checkpoint(work_dir: str, steps: int | None = None,
                        prefix: str = "model_ckpt_steps"):
    """Returns (ckpt_dict, path) or (None, None)."""
    if steps is not None and steps > 0:
        path = os.path.join(work_dir, f"{prefix}_{steps}.ckpt")
        paths = [path] if os.path.exists(path) else []
    else:
        paths = get_all_checkpoints(work_dir, prefix)
    if not paths:
        return None, None
    with open(paths[0], "rb") as f:
        return pickle.load(f), paths[0]


def extract_subtree(state: dict, key_path: str):
    """'params_g' or 'params_g/decoder' → sub-tree."""
    node = state
    for part in key_path.split("/"):
        if part:
            node = node[part]
    return node


def load_ckpt_state(work_dir: str, key_path: str = "", steps: int | None = None):
    ckpt, _path = get_last_checkpoint(work_dir, steps)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint in {work_dir}")
    state = ckpt["state"]
    return extract_subtree(state, key_path) if key_path else state


def save_checkpoint(work_dir: str, global_step: int, state, hparams: dict | None = None,
                    num_keep: int = 3, prefix: str = "model_ckpt_steps") -> str:
    """Write ``state`` (a tree of tensors or arrays) in the shared format,
    atomically (``.part`` then rename), then remove all but the newest
    ``num_keep`` checkpoints of ``prefix`` in ``work_dir``."""
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, f"{prefix}_{global_step}.ckpt")
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        pickle.dump({"global_step": int(global_step), "state": tree_to_numpy(state),
                     "hparams": dict(hparams) if hparams else None}, f)
    os.replace(tmp, path)
    for old in get_all_checkpoints(work_dir, prefix)[num_keep:]:
        os.remove(old)
    return path


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """The tree of ``template``'s structure with ``leaves`` in ``tree_leaves``'s order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_to_numpy(tree):
    """Tensors to numpy arrays; a None leaf (a ConanTask state without
    style has no ``vq_state``) stays None, as in a JAX tree."""
    return tree_map(lambda x: x.detach().cpu().numpy() if torch.is_tensor(x)
                    else None if x is None else np.asarray(x), tree)


def params_from_jax(tree, device: str | torch.device):
    """A JAX parameter or state tree (numpy leaves, as in a checkpoint or from
    ``jax.device_get``) → the same tree with torch tensors on ``device``.
    Float leaves become float32; integer and bool leaves keep their dtype;
    None stays None."""
    def leaf(x):
        if x is None:
            return None
        a = np.asarray(x)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        # np.array, not np.ascontiguousarray: that one turns a 0-d leaf (a
        # step counter, the VQ's flag) into shape (1,)
        return torch.from_numpy(np.array(a, order="C")).to(device)

    return tree_map(leaf, tree)


def params_from_state_dict(sd, names, device: str | torch.device | None = None):
    """The tree of ``names`` with each state-dict key replaced by ``sd``'s
    value (a tensor or a numpy array) on ``device`` (None: the card). Float
    values become float32, others keep their dtype; a leaf of ``names`` that
    is not a key (an int stride) is kept as it is. Keys of ``sd`` that
    ``names`` does not hold are ignored."""
    dev = resolve_device(device)

    def leaf(name):
        if not isinstance(name, str):
            return name
        x = sd[name]
        t = x.detach() if torch.is_tensor(x) else torch.from_numpy(np.array(x, order="C"))
        return t.to(dev, torch.float32 if t.is_floating_point() else t.dtype)

    return tree_map(leaf, names)


def state_dict_from_params(params, names) -> dict:
    """The inverse of ``params_from_state_dict``: ``{key: tensor on the
    CPU}`` for every key of ``names``, read from the same place in
    ``params``. Raises ValueError where the two trees differ in structure."""
    out = {}

    def walk(n, p, path):
        if isinstance(n, dict):
            if not isinstance(p, dict) or set(n) != set(p):
                raise ValueError(f"{path or '/'}: parameter keys "
                                 f"{sorted(p) if isinstance(p, dict) else type(p)} "
                                 f"are not the mapping's {sorted(n)}")
            for k in n:
                walk(n[k], p[k], f"{path}/{k}")
        elif isinstance(n, (list, tuple)):
            if not isinstance(p, (list, tuple)) or len(n) != len(p):
                raise ValueError(f"{path}: {len(n)} entries in the mapping, not {p!r:.40}")
            for i, (a, b) in enumerate(zip(n, p)):
                walk(a, b, f"{path}/{i}")
        elif isinstance(n, str):
            out[n] = torch.as_tensor(p).detach().cpu()

    walk(names, params, "")
    return out
