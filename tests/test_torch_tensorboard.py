"""The port's trainer writes TensorBoard as the JAX package's does
(``conan_tpu/train/trainer.py:60-66, 118-125``): every scalar it writes to
``metrics.jsonl`` goes to ``<work_dir>/tb`` tagged ``"{prefix}/{key}"`` at
the same step.

Five CPU steps of the small EmformerTask (tests/test_torch_emformer_train.py's
sizes) with ``tb_log_interval`` 2, a sanity validation and one at step 4.
TensorBoard's ``EventAccumulator`` reads the tags, steps and values back:
equal to ``metrics.jsonl`` (as float32, the event files' type), and equal
to what the JAX trainer's ``_log`` writes for the same records.
"""

import json
import os
import types

import numpy as np
import pytest

from conan_tpu.train.trainer import Trainer as JTrainer

from conan_tpu_torch.train import trainer as trainer_mod
from conan_tpu_torch.train.tasks import EmformerTask
from conan_tpu_torch.train.trainer import Trainer

from tests.test_torch_emformer_train import HP, _batch
from tests.torch_port_util import one_torch_thread  # noqa: F401


def _scalars(log_dir: str) -> dict:
    """{tag: [(step, value)]} of the event files under ``log_dir``."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def _records(work: str) -> list:
    with open(os.path.join(work, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_writes_tensorboard_as_metrics_jsonl(tmp_path):
    pytest.importorskip("tensorboard")
    work = str(tmp_path / "work")
    hp = dict(HP, max_updates=5, tb_log_interval=2, val_check_interval=4,
              num_sanity_val_steps=1, seed=3)
    task = EmformerTask(hp, device="cpu")

    def valid_fn(state, step):
        ce, acc = task._loss(state["params"], _batch(99))
        return {"ce": float(ce), "acc": float(acc)}

    Trainer(task, hp, work).fit(iter([_batch(20 + i) for i in range(5)]), valid_fn)

    records = _records(work)
    assert [(r["prefix"], r["step"]) for r in records] == \
        [("sanity", 0), ("tr", 2), ("tr", 4), ("val", 4)]
    want: dict = {}
    for r in records:
        for k, v in r.items():
            if k not in ("step", "prefix"):
                want.setdefault(f"{r['prefix']}/{k}", []).append((r["step"], np.float32(v)))
    got = _scalars(os.path.join(work, "tb"))
    assert got == want
    assert {"tr/ce", "tr/acc", "tr/skipped", "tr/steps_per_s", "val/ce", "val/acc",
            "sanity/ce"} <= set(got)

    # the JAX trainer's _log on the same records writes the same scalars
    jdir = str(tmp_path / "jax")
    from torch.utils.tensorboard import SummaryWriter

    jself = types.SimpleNamespace(_metrics_f=open(os.path.join(jdir + ".jsonl"), "w"),
                                  _tb=SummaryWriter(jdir))
    for r in records:
        metrics = {k: v for k, v in r.items() if k not in ("step", "prefix")}
        JTrainer._log(jself, r["step"], metrics, prefix=r["prefix"])
    jself._tb.close()
    jself._metrics_f.close()
    assert _scalars(jdir) == got


def test_trainer_goes_on_without_tensorboard(tmp_path, monkeypatch, caplog):
    """Where ``torch.utils.tensorboard`` does not import: one log line, no
    ``tb`` directory, ``metrics.jsonl`` as before."""
    import builtins

    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("No module named 'tensorboard'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    work = str(tmp_path / "work")
    hp = dict(HP, max_updates=2, tb_log_interval=2, val_check_interval=100)
    with caplog.at_level("INFO", logger=trainer_mod.__name__):
        Trainer(EmformerTask(hp, device="cpu"), hp, work).fit(iter([_batch(1), _batch(2)]))
    assert [r.message for r in caplog.records].count(
        "no TensorBoard writer (No module named 'tensorboard'): metrics go to "
        "metrics.jsonl only") == 1
    assert not os.path.exists(os.path.join(work, "tb"))
    assert [(r["prefix"], r["step"]) for r in _records(work)] == [("tr", 2)]
