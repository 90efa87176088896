"""Tracing and profiling helpers (``conan_tpu/utils/profiling.py``).

``Timer`` is a named cumulative wall-clock timer (the reference's
``utils/commons/meters.py:21-42``), ``LatencyHistogram`` a per-chunk latency
collector with a percentile summary, ``device_trace`` a ``torch.profiler``
trace of a region, and ``sync`` waits for the card's queued work on the
tensors it is given. The arithmetic is the JAX package's numpy arithmetic.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch

from conan_tpu_torch.checkpoint import tree_leaves
from conan_tpu_torch.device import resolve_device


class Timer:
    """Named cumulative wall-clock timer.

    with Timer("vocoder"): ...
    Timer.report() → {name: {"total_s", "count", "mean_ms"}}.
    It reads the host's clock: call ``sync`` on the region's outputs inside
    it to time the card's work too.
    """

    timer_map: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)

    def __init__(self, name: str, enable: bool = True):
        self.name = name
        self.enable = enable

    def __enter__(self):
        if self.enable:
            self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enable:
            Timer.timer_map[self.name] += time.perf_counter() - self.t
            Timer.counts[self.name] += 1

    @classmethod
    def report(cls) -> dict[str, dict]:
        return {k: {"total_s": v, "count": cls.counts[k],
                    "mean_ms": v / max(cls.counts[k], 1) * 1e3}
                for k, v in cls.timer_map.items()}

    @classmethod
    def reset(cls):
        cls.timer_map.clear()
        cls.counts.clear()


class LatencyHistogram:
    """Per-chunk latency collector (ms) with a percentile summary."""

    def __init__(self):
        self.samples: list[float] = []

    @contextlib.contextmanager
    def measure(self, sync_fn=None):
        t0 = time.perf_counter()
        yield
        if sync_fn is not None:
            sync_fn()
        self.samples.append((time.perf_counter() - t0) * 1e3)

    def record(self, ms: float):
        self.samples.append(ms)

    def summary(self, drop_first: int = 5) -> dict:
        """n, p50/p90/p95/p99, mean and max in ms over the samples after the
        first ``drop_first`` (over all of them if none is left)."""
        s = np.asarray(self.samples[drop_first:] or self.samples)
        return {
            "n": len(s),
            "p50_ms": float(np.percentile(s, 50)),
            "p90_ms": float(np.percentile(s, 90)),
            "p95_ms": float(np.percentile(s, 95)),
            "p99_ms": float(np.percentile(s, 99)),
            "mean_ms": float(s.mean()),
            "max_ms": float(s.max()),
        }


@contextlib.contextmanager
def device_trace(log_dir: str, device: str | torch.device | None = None):
    """``torch.profiler`` over the region: the host's ops and, on the card
    (``device`` None or CUDA), its kernels. On leaving, the trace is written
    to ``log_dir`` as ``<worker>.<time>.pt.trace.json``, a Chrome trace that
    ``chrome://tracing`` and TensorBoard's profile plugin read. Yields the
    profiler (``key_averages()`` and the like)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def sync(tree) -> None:
    """Wait for the work queued on each CUDA device that holds a tensor of
    ``tree`` (``torch.cuda.synchronize`` of that device); CPU tensors and
    other leaves need no wait."""
    devices = {x.device for x in tree_leaves(tree)
               if torch.is_tensor(x) and x.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
