"""A minimal training loop (``conan_tpu/train/trainer.py:44-210``).

``Trainer(task, hp, work_dir).fit(train_iter)`` initialises the task's state
from ``hp["seed"]``, runs ``task.train_step`` on each batch up to
``max_updates`` with one ``torch.Generator`` on the task's device (seeded
``seed + 17``) for the steps' random draws, appends the running averages of
the step metrics to ``<work_dir>/metrics.jsonl`` every ``tb_log_interval``
steps (reading them back from the device only then), and saves the final
state as a checkpoint in the JAX package's format. A task with a
``host_hook`` (ConanTask's k-means bootstrap) has it run before each step
from ``vq_start + 1`` on until it reports done. With
``use_random_ref_after`` n, the step gets ``use_random_ref=step >= n``.
Validation, resume and the mesh are not ported (ROADMAP.md, modules still
to port: the trainer's options).
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict
from collections.abc import Mapping

import torch

from conan_tpu_torch.checkpoint import save_checkpoint

log = logging.getLogger(__name__)


def _plain(hp):
    return {k: _plain(v) if isinstance(v, Mapping) else v for k, v in hp.items()}


class Trainer:
    def __init__(self, task, hp, work_dir: str, *, use_random_ref_after: int | None = None):
        self.task = task
        self.use_random_ref_after = use_random_ref_after
        self.hp = _plain(hp)
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.max_updates = self.hp.get("max_updates", 1000000)
        self.tb_log_interval = self.hp.get("tb_log_interval", 100)
        self.seed = self.hp.get("seed", 1234)

    def _log(self, f, step: int, pending: list, seconds: float) -> dict:
        sums: dict = defaultdict(float)
        for metrics in pending:
            for k, v in metrics.items():
                sums[k] += float(v)
        avg = {k: v / len(pending) for k, v in sums.items()}
        avg["steps_per_s"] = len(pending) / seconds
        f.write(json.dumps({"step": step, "prefix": "tr", **avg}) + "\n")
        f.flush()
        if avg.get("skipped", 0.0) > 0:
            log.warning("step %d: %.0f of the last %d updates were SKIPPED (non-finite "
                        "grads)", step, avg["skipped"] * len(pending), len(pending))
        return avg

    def _hook_due(self, step: int) -> bool:
        vq_start = self.hp.get("vq_start")
        return vq_start is not None and step >= max(int(vq_start), 0) + 1

    def fit(self, train_iter) -> dict:
        """Train on the batches of ``train_iter``; returns the final state."""
        state = self.task.init_state(torch.Generator().manual_seed(self.seed))
        generator = torch.Generator(device=self.task.device).manual_seed(self.seed + 17)
        hook_done = not hasattr(self.task, "host_hook")
        step = 0
        pending: list = []
        t_last = time.perf_counter()
        with open(os.path.join(self.work_dir, "metrics.jsonl"), "a") as f:
            for batch in train_iter:
                if step >= self.max_updates:
                    break
                if not hook_done and self._hook_due(step):
                    new, hook_done = self.task.host_hook(state, step, batch)
                    if new is not None:
                        state = new
                kwargs = ({} if self.use_random_ref_after is None
                          else {"use_random_ref": step >= self.use_random_ref_after})
                state, metrics = self.task.train_step(state, batch, generator, **kwargs)
                step += 1
                pending.append(metrics)
                if step % self.tb_log_interval == 0:
                    avg = self._log(f, step, pending, time.perf_counter() - t_last)
                    log.info("step %d: %s", step, " ".join(f"{k}={v:.4f}"
                                                           for k, v in avg.items()))
                    pending.clear()
                    t_last = time.perf_counter()
        save_checkpoint(self.work_dir, step, state, self.hp)
        return state
