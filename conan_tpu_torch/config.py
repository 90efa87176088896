"""Configuration: the port's own copy of ``conan_tpu/config.py``:
``HParams``, ``load_config`` with recursive ``base_config`` inheritance, and
a config with dotted overrides on top (``parse_hparams_overrides``,
``set_hparams``).
"""

from __future__ import annotations

import os
import re
from types import MappingProxyType
from typing import Any, Iterator, Mapping

import yaml


class HParams(Mapping[str, Any]):
    """Read-only nested mapping over a loaded config; nested dicts are
    wrapped lazily."""

    __slots__ = ("_d",)

    def __init__(self, d: Mapping[str, Any]):
        object.__setattr__(self, "_d", MappingProxyType(dict(d)))

    def __getitem__(self, k: str) -> Any:
        v = self._d[k]
        return HParams(v) if isinstance(v, dict) else v

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __repr__(self) -> str:
        return f"HParams({dict(self._d)!r})"


def _deep_update(base: dict, new: dict) -> dict:
    """Recursively merge ``new`` into ``base`` (new wins), like the
    reference's ``override_config`` (`hparams.py:17-24`)."""
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_config(config_path: str, *, _seen: set[str] | None = None) -> dict:
    """Load a YAML config with recursive ``base_config`` inheritance.

    DFS over parents with a first-visit-wins cycle guard, matching the
    reference loader semantics (`hparams.py:51-72`): parents are merged in
    listed order (later parents override earlier ones), then the child
    overrides all parents.
    """
    _seen = _seen if _seen is not None else set()
    config_path = os.path.abspath(config_path)
    if config_path in _seen:
        return {}
    _seen.add(config_path)
    with open(config_path) as f:
        cfg = yaml.safe_load(f) or {}
    bases = cfg.pop("base_config", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for b in bases:
        if not os.path.isabs(b):
            # Paths are repo-root-relative (like the reference's egs/...) or
            # relative to the including file; try both.
            cand = os.path.join(os.path.dirname(config_path), b)
            b = cand if os.path.exists(cand) else os.path.join(_repo_root(), b)
        _deep_update(merged, load_config(b, _seen=_seen))
    _deep_update(merged, cfg)
    return merged


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _set_dotted(d: dict, key: str, value: Any) -> None:
    parts = key.split(".")
    for p in parts[:-1]:
        nxt = d.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            d[p] = nxt
        d = nxt
    d[parts[-1]] = value


def _parse_value(v: str) -> Any:
    """An override's value string → a Python value, by YAML (the reference
    used ``eval``); scientific notation such as "1e-4", which YAML 1.1 leaves
    a string, is a float."""
    v = v.strip()
    if v == "":
        return ""
    if re.fullmatch(r"[-+]?(\d+\.?\d*|\.\d+)[eE][-+]?\d+", v):
        return float(v)
    try:
        return yaml.safe_load(v)
    except yaml.YAMLError:
        return v


def parse_hparams_overrides(s: str) -> dict:
    """``"a=1,b.c=[2,3],d=x"`` → a nested dict of overrides; commas inside
    brackets and braces do not split."""
    out: dict = {}
    if not s:
        return out
    for part in re.split(r",(?![^\[\]{}()]*[\]}\)])", s):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad hparams override (need k=v): {part!r}")
        k, v = part.split("=", 1)
        _set_dotted(out, k.strip(), _parse_value(v))
    return out


def set_hparams(config: str = "", hparams_str: str = "") -> HParams:
    """``config`` with its bases (none when empty), then the dotted overrides
    of ``hparams_str`` on top. The JAX package's experiment half of
    ``set_hparams`` (``exp_name``, the work dir's saved ``config.yaml``,
    ``--reset``/``--infer``/``--validate``) and ``hparams_to_json`` wait for
    the training entry point that will call them (ROADMAP.md)."""
    cfg = load_config(config) if config else {}
    return HParams(_deep_update(cfg, parse_hparams_overrides(hparams_str)))
