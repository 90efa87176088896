"""Training set-up (``conan_tpu/train/run.py:33-80``): the task and the
batch iterator a config names.

    task, kind = build_task(hp)                  # on the CUDA card by default
    Trainer(task, hp, work_dir, use_random_ref_after=use_random_ref_after(hp, kind)
            ).fit(build_train_iter(hp, kind))

Kinds ``conan`` and ``vocoder``; the others raise NotImplementedError. The
command-line entry point comes with validation and the experiment half of
``set_hparams`` (ROADMAP.md).
"""

from __future__ import annotations

import torch

from conan_tpu_torch.data.batching import BucketLadder
from conan_tpu_torch.data.datasets import ConanDataset, VocoderDataset
from conan_tpu_torch.data.loader import BatchIterator
from conan_tpu_torch.train.tasks import NOT_PORTED, ConanTask, VocoderTask

TASK_ALIASES = {
    "tasks.Conan.Conan.ConanTask": "conan",
    "tasks.Conan.Conan.VCPostnetTask": "postnet",
    "tasks.Emformer.Emformer.EmformerTask": "emformer",
    "tasks.vocoder.hifigan.HifiGanTask": "vocoder",
    "conan": "conan", "emformer": "emformer", "vocoder": "vocoder", "postnet": "postnet",
}
TASKS = {"conan": ConanTask, "vocoder": VocoderTask}


def _ported(kind: str) -> str:
    if kind not in TASKS:
        raise NotImplementedError(f"the {kind} task " + NOT_PORTED.format(
            "PostnetTask and EmformerTask"))
    return kind


def build_task(hp, device: str | torch.device | None = None):
    """(task, kind) for ``hp["task_cls"]``, on ``device`` (None: the card)."""
    kind = TASK_ALIASES.get(hp.get("task_cls", "conan"))
    if kind is None:
        raise ValueError(f"unknown task_cls: {hp.get('task_cls')}")
    return TASKS[_ported(kind)](hp, device=device), kind


def use_random_ref_after(hp, kind: str) -> int | None:
    """The step from which Conan's reference is another utterance of the
    speaker (``random_speaker_steps``), a flip the trainer makes on the
    host; None for the other tasks."""
    return hp.get("random_speaker_steps", 100000) if kind == "conan" else None


def build_train_iter(hp, kind: str):
    """An endless iterator of training batches from the train split under
    ``hp["binary_data_dir"]``. Conan batches are padded to the bucket
    ladder's rung (64 up to ``max_frames``), the reference mels to their own."""
    _ported(kind)
    data_dir = hp["binary_data_dir"]
    if kind == "vocoder":
        ds = VocoderDataset(data_dir, "train", hp)
        return iter(BatchIterator(ds, ds.collate, max_tokens=None,
                                  max_sentences=hp.get("max_sentences", 16)))
    ladder = BucketLadder(min_len=64, max_len=hp.get("max_frames", 3000))
    ds = ConanDataset(data_dir, "train", hp)

    def collate(samples, target_len=None):
        ref_max = max(s["ref_mel"].shape[0] for s in samples)
        return ds.collate(samples, target_len, ladder.fit(ref_max))

    return iter(BatchIterator(ds, collate, max_tokens=hp.get("max_tokens"),
                              max_sentences=hp.get("max_sentences"), bucket=ladder))
