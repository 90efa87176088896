"""Checkpoint I/O in the JAX package's format (``conan_tpu/train/checkpoint.py``).

A checkpoint is one pickle of ``{"global_step", "state": tree of numpy arrays,
"hparams": dict}`` named ``model_ckpt_steps_<N>.ckpt``. The tree is nested
dicts and lists; its key paths are the contract both packages share, so
``params_from_jax`` only turns leaves into tensors and keeps every key.
"""

from __future__ import annotations

import glob
import os
import pickle
import re

import numpy as np
import torch


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
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return tree_map(leaf, tree)
