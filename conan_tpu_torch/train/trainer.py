"""The training loop (``conan_tpu/train/trainer.py:44-210``).

``Trainer(task, hp, work_dir).fit(train_iter, valid_fn)`` starts from the
newest ``model_ckpt_steps_<N>.ckpt`` in ``work_dir`` (its state and step;
the batch iterator and the generator restart from their seeds, as the JAX
package's do), else from a state initialised from ``hp["seed"]``. It runs
``task.train_step`` on each batch up to ``max_updates`` with one
``torch.Generator`` on the task's device (seeded ``seed + 17``) for the
steps' random draws, and appends the running averages of the step metrics
to ``<work_dir>/metrics.jsonl`` every ``tb_log_interval`` steps (reading
them back from the device only then). Every ``val_check_interval`` steps it
runs ``valid_fn(state, step)`` (a ``val`` line; with ``save_best``, a
``model_ckpt_best`` checkpoint when ``valid_monitor_key`` improves) and
saves a checkpoint, keeping the newest ``num_ckpt_keep``; once more at the
end. With ``num_sanity_val_steps`` not 0 it validates once before the first
step (a ``sanity`` line). The first run in a work dir archives
``conan_tpu_torch/`` and ``egs/`` as ``codes.zip``. A task with a
``host_hook`` (ConanTask's k-means bootstrap) has it run before each step
from ``vq_start + 1`` on until it reports done. With
``use_random_ref_after`` n, the step gets ``use_random_ref=step >= n``.
Gradient accumulation lives in the tasks' optimizers (``optim.Accumulate``):
each batch here is one mini-step, and its accumulator rides in the state and
the checkpoint. Where ``torch.utils.tensorboard`` imports, rank 0 also
writes every scalar of ``metrics.jsonl`` to TensorBoard event files under
``<work_dir>/tb``, tagged ``"{prefix}/{key}"`` at the same step (the JAX
trainer's optional writer); where it does not, one log line says so and
training goes on without it. The writer is closed at the end of ``fit``.

Data parallelism (the JAX trainer's mesh, ``trainer.py:45-51, 106, 137``):
with the task's ``world`` (``parallel/dist.py``) each rank
runs this loop on its own rows of every global batch, through the task's
step, which sums the gradients across the ranks. Every rank starts from
rank 0's state (its init or the newest checkpoint, which every rank reads,
broadcast), seeds its generator alike and runs the hook alike. The step's
metrics are already the global batch's and the same on every rank. Rank 0
alone writes ``metrics.jsonl``, the checkpoints, the best checkpoint and
``codes.zip`` and runs the validation; the other ranks wait at a barrier.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
import time
from collections import defaultdict
from collections.abc import Mapping

import torch

from conan_tpu_torch.checkpoint import get_last_checkpoint, params_from_jax, save_checkpoint
from conan_tpu_torch.parallel import dist

log = logging.getLogger(__name__)


def _plain(hp):
    return {k: _plain(v) if isinstance(v, Mapping) else v for k, v in hp.items()}


def _summary_writer(log_dir: str):
    """A TensorBoard ``SummaryWriter`` on ``log_dir``, or None where
    ``torch.utils.tensorboard`` does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        log.info("no TensorBoard writer (%s): metrics go to metrics.jsonl only", e)
        return None
    return SummaryWriter(log_dir)


class Trainer:
    def __init__(self, task, hp, work_dir: str, *, use_random_ref_after: int | None = None):
        self.task = task
        self.world = getattr(task, "world", None)
        self.is_main = self.world is None or self.world.rank == 0
        self.use_random_ref_after = use_random_ref_after
        self.hp = _plain(hp)
        self.work_dir = work_dir
        self.max_updates = self.hp.get("max_updates", 1000000)
        self.tb_log_interval = self.hp.get("tb_log_interval", 100)
        self.val_check_interval = self.hp.get("val_check_interval", 2000)
        self.num_ckpt_keep = self.hp.get("num_ckpt_keep", 3)
        self.seed = self.hp.get("seed", 1234)
        self.valid_monitor_key = self.hp.get("valid_monitor_key", "val_loss")
        self.save_best = self.hp.get("save_best", False)
        self._best = float("inf")
        self._tb = None
        if self.is_main:
            os.makedirs(work_dir, exist_ok=True)
            self._snapshot_code()
            self._tb = _summary_writer(os.path.join(work_dir, "tb"))
        dist.barrier(self.world)

    def _snapshot_code(self) -> None:
        """``codes.zip`` of the port and the configs, once per work dir
        (reference trainer.py:543-559)."""
        dst = os.path.join(self.work_dir, "codes.zip")
        if os.path.exists(dst):
            return
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        tmp = os.path.join(self.work_dir, "_codes_tmp")
        for name in ("conan_tpu_torch", "egs"):
            if os.path.isdir(os.path.join(root, name)):
                shutil.copytree(os.path.join(root, name), os.path.join(tmp, name),
                                dirs_exist_ok=True,
                                ignore=shutil.ignore_patterns("__pycache__", "*.so"))
        shutil.make_archive(dst[:-4], "zip", tmp)
        shutil.rmtree(tmp)

    def _write(self, f, step: int, prefix: str, metrics: dict) -> None:
        values = {k: float(v) for k, v in metrics.items()}
        f.write(json.dumps({"step": step, "prefix": prefix, **values}) + "\n")
        f.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(f"{prefix}/{k}", v, step)

    def _validate(self, f, valid_fn, state: dict, step: int) -> None:
        vm = valid_fn(state, step)
        self._write(f, step, "val", vm)
        log.info("step %d validation: %s", step, " ".join(f"{k}={v:.4f}"
                                                          for k, v in vm.items()))
        monitored = vm.get(self.valid_monitor_key, sum(vm.values()) if vm else None)
        if self.save_best and monitored is not None and monitored < self._best:
            self._best = monitored
            save_checkpoint(self.work_dir, step, state, self.hp, num_keep=1,
                            prefix="model_ckpt_best")

    def _log(self, f, step: int, pending: list, seconds: float) -> dict:
        sums: dict = defaultdict(float)
        for metrics in pending:
            for k, v in metrics.items():
                sums[k] += float(v)
        avg = {k: v / len(pending) for k, v in sums.items()}
        avg["steps_per_s"] = len(pending) / seconds
        self._write(f, step, "tr", avg)
        if avg.get("skipped", 0.0) > 0:
            log.warning("step %d: %.0f of the last %d updates were SKIPPED (non-finite "
                        "grads)", step, avg["skipped"] * len(pending), len(pending))
        return avg

    def _hook_due(self, step: int) -> bool:
        vq_start = self.hp.get("vq_start")
        return vq_start is not None and step >= max(int(vq_start), 0) + 1

    def _main_only(self, fn) -> None:
        """``fn()`` on rank 0 while the other ranks wait at a barrier."""
        if self.is_main:
            fn()
        dist.barrier(self.world)

    def fit(self, train_iter, valid_fn=None) -> dict:
        """Train on the batches of ``train_iter`` (under a world, this rank's
        rows of each global batch); returns the final state."""
        ckpt, path = get_last_checkpoint(self.work_dir)
        if ckpt is not None:
            log.info("resuming from %s (step %d)", path, ckpt["global_step"])
            state = params_from_jax(ckpt["state"], self.task.device)
        else:
            state = self.task.init_state(torch.Generator().manual_seed(self.seed))
        state = dist.broadcast_state(state, self.world)
        step = int(state["step"])
        generator = torch.Generator(device=self.task.device).manual_seed(self.seed + 17)
        hook_done = not hasattr(self.task, "host_hook")
        pending: list = []
        t_last = time.perf_counter()
        metrics_path = os.path.join(self.work_dir, "metrics.jsonl")
        with open(metrics_path, "a") if self.is_main else contextlib.nullcontext() as f:
            if valid_fn is not None and self.hp.get("num_sanity_val_steps", 0) != 0:
                self._main_only(lambda: self._write(f, step, "sanity", valid_fn(state, step)))
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
                    if self.is_main:
                        avg = self._log(f, step, pending, time.perf_counter() - t_last)
                        log.info("step %d: %s", step, " ".join(f"{k}={v:.4f}"
                                                               for k, v in avg.items()))
                    pending.clear()
                    t_last = time.perf_counter()
                if step % self.val_check_interval == 0:
                    def validate_and_save(step=step, state=state):
                        if valid_fn is not None:
                            self._validate(f, valid_fn, state, step)
                        save_checkpoint(self.work_dir, step, state, self.hp,
                                        num_keep=self.num_ckpt_keep)
                    self._main_only(validate_and_save)
        self._main_only(lambda: save_checkpoint(self.work_dir, step, state, self.hp,
                                                num_keep=self.num_ckpt_keep))
        if self._tb is not None:
            self._tb.close()
        return state
