"""The training CLI (``conan_tpu/train/run.py``):

    python -m conan_tpu_torch.train.run --config egs/soak_r5/emformer.yaml \
        --exp_name <name> [--hparams k=v,...] [--validate] [--reset] [--device cpu]

The config's ``task_cls`` picks the task (the reference's class paths are
aliases): ``emformer``, ``conan`` and ``vocoder`` train; ``postnet`` and
``--infer`` raise NotImplementedError (ROADMAP.md). The run trains in
``checkpoints/<exp_name>`` (an absolute ``--exp_name`` is the work dir
itself) on the CUDA card unless ``--device`` says otherwise, validating on
the valid split where there is one; ``--validate`` evaluates the newest
checkpoint and prints the metrics as one JSON line. From Python:

    task, kind = build_task(hp)                  # on the CUDA card by default
    Trainer(task, hp, work_dir, use_random_ref_after=use_random_ref_after(hp, kind)
            ).fit(build_train_iter(hp, kind), build_valid_fn(hp, task, kind))
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import torch

from conan_tpu_torch.checkpoint import get_last_checkpoint, load_ckpt_state, params_from_jax
from conan_tpu_torch.config import set_hparams
from conan_tpu_torch.data.batching import BucketLadder
from conan_tpu_torch.data.datasets import ConanDataset, EmformerDataset, VocoderDataset
from conan_tpu_torch.data.loader import BatchIterator
from conan_tpu_torch.train.tasks import NOT_PORTED, ConanTask, EmformerTask, VocoderTask
from conan_tpu_torch.train.trainer import Trainer

log = logging.getLogger("conan_tpu_torch.run")

TASK_ALIASES = {
    "tasks.Conan.Conan.ConanTask": "conan",
    "tasks.Conan.Conan.VCPostnetTask": "postnet",
    "tasks.Emformer.Emformer.EmformerTask": "emformer",
    "tasks.vocoder.hifigan.HifiGanTask": "vocoder",
    "conan": "conan", "emformer": "emformer", "vocoder": "vocoder", "postnet": "postnet",
}
TASKS = {"conan": ConanTask, "emformer": EmformerTask, "vocoder": VocoderTask}


def _ported(kind: str) -> str:
    if kind not in TASKS:
        raise NotImplementedError(f"the {kind} task " + NOT_PORTED.format("PostnetTask"))
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


def _seg_rc(hp) -> dict:
    return {"seg": hp["chunk_size"] // 20, "rc": hp["right_context"]}


def build_train_iter(hp, kind: str):
    """An endless iterator of training batches from the train split under
    ``hp["binary_data_dir"]``. Conan and Emformer batches are padded to the
    bucket ladder's rung (64 up to ``max_frames``), Conan's reference mels to
    their own, Emformer's mels to whole segments plus the lookahead."""
    _ported(kind)
    data_dir = hp["binary_data_dir"]
    if kind == "vocoder":
        ds = VocoderDataset(data_dir, "train", hp)
        return iter(BatchIterator(ds, ds.collate, max_tokens=None,
                                  max_sentences=hp.get("max_sentences", 16)))
    ladder = BucketLadder(min_len=64, max_len=hp.get("max_frames", 3000))
    if kind == "emformer":
        ds = EmformerDataset(data_dir, "train", hp)

        def collate(samples, target_len=None):
            return ds.collate(samples, target_len, **_seg_rc(hp))
    else:
        ds = ConanDataset(data_dir, "train", hp)

        def collate(samples, target_len=None):
            ref_max = max(s["ref_mel"].shape[0] for s in samples)
            return ds.collate(samples, target_len, ladder.fit(ref_max))

    return iter(BatchIterator(ds, collate, max_tokens=hp.get("max_tokens"),
                              max_sentences=hp.get("max_sentences"), bucket=ladder))


def _p2floor(n: int) -> int:
    p = 64
    while p * 2 <= n:
        p *= 2
    return p


def _conan_valid_item(s: dict) -> dict:
    """A valid item cut to the power of two at or below its length (64 at
    least), its reference mel too: the mel losses are unmasked, so the
    conan batches hold one item each and are cut, never padded."""
    T = _p2floor(max(64, s["mel"].shape[0]))
    s = dict(s, mel=s["mel"][:T], content=s["content"][:T], f0=s["f0"][:T], uv=s["uv"][:T])
    s["ref_mel"] = s["ref_mel"][:_p2floor(max(64, s["ref_mel"].shape[0]))]
    return s


def _validation_vocoder(hp, device):
    """(generator, params) of the vocoder checkpoint dir ``vocoder_ckpt``,
    or (None, None) where it names no dir."""
    from conan_tpu_torch.infer.build import _load_dir_config
    from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig, HifiGanGenerator

    voc_dir = hp.get("vocoder_ckpt")
    if not voc_dir or not os.path.isdir(voc_dir):
        return None, None
    hp_voc = _load_dir_config(voc_dir)
    gen = HifiGanGenerator(HifiGanConfig.from_hparams(hp_voc) if "upsample_rates" in hp_voc
                           else HifiGanConfig())
    return gen, params_from_jax(load_ckpt_state(voc_dir, "params_g"), device)


def build_valid_fn(hp, task, kind: str):
    """The validation function on up to ``num_valid_stats`` items (16) of
    the valid split (``eval_max_batches`` caps the batches), or None where
    the split is missing or empty. Emformer items are sorted by length and
    batched by 4 at the ladder's rung; vocoder crops by 4; Conan items one
    at a time, cut by ``_conan_valid_item``."""
    from conan_tpu_torch.train import validation

    data_dir = hp["binary_data_dir"]
    if not os.path.exists(f"{data_dir}/valid_lengths.npy"):
        return None
    n_stats = int(hp.get("num_valid_stats", 16))
    max_batches = int(hp.get("eval_max_batches", -1) or -1)
    if max_batches > 0:
        n_stats = min(n_stats, max_batches * (1 if kind == "conan" else 4))
    if kind == "conan":
        ds = ConanDataset(data_dir, "valid", hp)
        if not len(ds):
            return None
        batches = [ds.collate([_conan_valid_item(ds[i])]) for i in range(min(n_stats, len(ds)))]
        vocoder, vocoder_params = _validation_vocoder(hp, task.device)
        return validation.make_conan_valid_fn(
            task, batches, work_dir=hp["work_dir"], vocoder=vocoder,
            vocoder_params=vocoder_params, sample_rate=hp.get("audio_sample_rate", 16000),
            num_plots=int(hp.get("num_valid_plots", 4)),
            infer_interval=int(hp.get("valid_infer_interval", 1)))
    if kind == "emformer":
        ds = EmformerDataset(data_dir, "valid", hp)
        if not len(ds):
            return None
        items = sorted((ds[i] for i in range(min(n_stats, len(ds)))),
                       key=lambda s: s["mel"].shape[0])
        ladder = BucketLadder(min_len=64, max_len=hp.get("max_frames", 3000))
        batches = [ds.collate(items[j:j + 4],
                              target_len=ladder.fit(max(s["mel"].shape[0]
                                                        for s in items[j:j + 4])),
                              **_seg_rc(hp))
                   for j in range(0, len(items), 4)]
        return validation.make_emformer_valid_fn(task, batches, work_dir=hp["work_dir"])
    if kind == "vocoder":
        ds = VocoderDataset(data_dir, "valid", hp)
        n = min(n_stats, len(ds))
        if not n:
            return None
        batches = [ds.collate([ds[i] for i in range(j, min(j + 4, n))])
                   for j in range(0, n, 4)]
        return validation.make_vocoder_valid_fn(task, batches)
    raise ValueError(kind)


def run_validate(hp, device: str | torch.device | None = None) -> None:
    """``--validate``: the metrics of the newest checkpoint in the work dir on
    the valid split, printed as one JSON line; an error logged where there is
    no valid split or no checkpoint."""
    task, kind = build_task(hp, device=device)
    valid_fn = build_valid_fn(hp, task, kind)
    if valid_fn is None:
        log.error("no validation split under %s", hp["binary_data_dir"])
        return
    ckpt, path = get_last_checkpoint(hp["work_dir"])
    if ckpt is None:
        log.error("no checkpoint in %s", hp["work_dir"])
        return
    step = int(ckpt["global_step"])
    log.info("validating %s (step %d)", path, step)
    vm = valid_fn(params_from_jax(ckpt["state"], task.device), step)
    print(json.dumps({"step": step, **{k: float(v) for k, v in vm.items()}}), flush=True)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    argv = list(argv if argv is not None else sys.argv[1:])
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    device = ap.parse_known_args(argv)[0].device
    hp = set_hparams(argv=argv)
    if hp.get("infer"):
        raise NotImplementedError("--infer (run_test, run_test_vocoder) "
                                  + NOT_PORTED.format("the training CLI's --infer"))
    if hp.get("validate"):
        run_validate(hp, device)
        return
    task, kind = build_task(hp, device=device)
    log.info("starting %s training in %s on %s (train_precision %s)", kind, hp["work_dir"],
             task.device, hp.get("train_precision", "highest"))
    Trainer(task, hp, hp["work_dir"], use_random_ref_after=use_random_ref_after(hp, kind)
            ).fit(build_train_iter(hp, kind), build_valid_fn(hp, task, kind))


if __name__ == "__main__":
    main()
