"""The training CLI (``conan_tpu/train/run.py``):

    python -m conan_tpu_torch.train.run --config egs/soak_r5/emformer.yaml \
        --exp_name <name> [--hparams k=v,...] [--validate] [--infer] [--reset] \
        [--device cpu]

The config's ``task_cls`` picks the task (the reference's class paths are
aliases): ``emformer``, ``conan``, ``vocoder`` and ``postnet`` (on the frozen
Conan of ``fs2_ckpt_dir``, with ``spec_min``/``spec_max`` from
``<binary_data_dir>/spec_stats.npz`` where the config has null: run
``python -m conan_tpu_torch.data.spec_stats --config ...`` first) train.
The run trains in ``checkpoints/<exp_name>`` (an absolute ``--exp_name`` is
the work dir itself) on the CUDA card unless ``--device`` says otherwise,
validating on the valid split where there is one; ``--validate`` evaluates
the newest checkpoint and prints the metrics as one JSON line. ``--infer``
converts the test split: ``run_test_vocoder`` (copy-synthesis) for a
vocoder config, ``run_test`` (the composed streaming engine, with the
stream-vs-offline guard and ``infer_manifest.json``) for the others. From
Python:

    task, kind = build_task(hp)                  # on the CUDA card by default
    Trainer(task, hp, work_dir, use_random_ref_after=use_random_ref_after(hp, kind)
            ).fit(build_train_iter(hp, kind), build_valid_fn(hp, task, kind))
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import sys
import time

import numpy as np
import torch

from conan_tpu_torch.checkpoint import get_last_checkpoint, load_ckpt_state, params_from_jax
from conan_tpu_torch.config import set_hparams
from conan_tpu_torch.data.batching import BucketLadder
from conan_tpu_torch.data.datasets import ConanDataset, EmformerDataset, VocoderDataset
from conan_tpu_torch.data.loader import BatchIterator
from conan_tpu_torch.data.record_store import RecordReader
from conan_tpu_torch.device import resolve_device
from conan_tpu_torch.infer.build import (_load_dir_config, build_engine, get_vocoder_cls,
                                         streamable)
from conan_tpu_torch.infer.run_vc import save_wav
from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig
from conan_tpu_torch.ops.conv import fold_weight_norm
from conan_tpu_torch.ops.precision import precision_scope
from conan_tpu_torch.parallel import dist
from conan_tpu_torch.train.tasks import ConanTask, EmformerTask, PostnetTask, VocoderTask
from conan_tpu_torch.train.trainer import Trainer

log = logging.getLogger("conan_tpu_torch.run")

TASK_ALIASES = {
    "tasks.Conan.Conan.ConanTask": "conan",
    "tasks.Conan.Conan.VCPostnetTask": "postnet",
    "tasks.Emformer.Emformer.EmformerTask": "emformer",
    "tasks.vocoder.hifigan.HifiGanTask": "vocoder",
    "conan": "conan", "emformer": "emformer", "vocoder": "vocoder", "postnet": "postnet",
}
TASKS = {"conan": ConanTask, "emformer": EmformerTask, "vocoder": VocoderTask,
         "postnet": PostnetTask}


def build_task(hp, device: str | torch.device | None = None,
               world: dist.World | None = None):
    """(task, kind) for ``hp["task_cls"]``, on ``device`` (None: the
    world's, else the card), data-parallel over ``world``."""
    kind = TASK_ALIASES.get(hp.get("task_cls", "conan"))
    if kind is None:
        raise ValueError(f"unknown task_cls: {hp.get('task_cls')}")
    if kind != "postnet":
        return TASKS[kind](hp, device=device, world=world), kind
    pre = load_ckpt_state(hp["fs2_ckpt_dir"])
    if hp.get("spec_min") is None:
        stats = np.load(f"{hp['binary_data_dir']}/spec_stats.npz")
        hp = dict(hp, spec_min=[float(x) for x in stats["spec_min"]],
                  spec_max=[float(x) for x in stats["spec_max"]])
    return PostnetTask(hp, pre["params_g"], pre.get("vq_state"), device=device,
                       world=world), kind


def use_random_ref_after(hp, kind: str) -> int | None:
    """The step from which Conan's reference is another utterance of the
    speaker (``random_speaker_steps``), a flip the trainer makes on the
    host; None for the other tasks."""
    return hp.get("random_speaker_steps", 100000) if kind == "conan" else None


def _seg_rc(hp) -> dict:
    return {"seg": hp["chunk_size"] // 20, "rc": hp["right_context"]}


def build_train_iter(hp, kind: str, world: dist.World | None = None):
    """An endless iterator of training batches from the train split under
    ``hp["binary_data_dir"]``. Conan and Emformer batches are padded to the
    bucket ladder's rung (64 up to ``max_frames``), Conan's reference mels to
    their own, Emformer's mels to whole segments plus the lookahead; the
    postnet reads Conan's batches. With a ``world``, this rank's rows of
    each global batch (``data/loader.py``)."""
    data_dir = hp["binary_data_dir"]
    if kind == "vocoder":
        ds = VocoderDataset(data_dir, "train", hp)
        return iter(BatchIterator(ds, ds.collate, max_tokens=None,
                                  max_sentences=hp.get("max_sentences", 16), world=world))
    ladder = BucketLadder(min_len=64, max_len=hp.get("max_frames", 3000))
    if kind == "emformer":
        ds = EmformerDataset(data_dir, "train", hp)

        def collate(samples, target_len=None, ref_target_len=None):
            return ds.collate(samples, target_len, **_seg_rc(hp))
    else:
        ds = ConanDataset(data_dir, "train", hp)

        def collate(samples, target_len=None, ref_target_len=None):
            if ref_target_len is None:
                ref_target_len = ladder.fit(max(s["ref_mel"].shape[0] for s in samples))
            return ds.collate(samples, target_len, ref_target_len)

    return iter(BatchIterator(ds, collate, max_tokens=hp.get("max_tokens"),
                              max_sentences=hp.get("max_sentences"), bucket=ladder, world=world))


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
    the generator the registry names by ``hp["vocoder"]`` ("HifiGAN" where
    unset), or (None, None) where it names no dir."""
    voc_dir = hp.get("vocoder_ckpt")
    if not voc_dir or not os.path.isdir(voc_dir):
        return None, None
    hp_voc = _load_dir_config(voc_dir)
    gen = get_vocoder_cls(hp.get("vocoder") or "HifiGAN")(
        HifiGanConfig.from_hparams(hp_voc) if "upsample_rates" in hp_voc else HifiGanConfig())
    return gen, params_from_jax(load_ckpt_state(voc_dir, "params_g"), device)


def build_valid_fn(hp, task, kind: str):
    """The validation function on up to ``num_valid_stats`` items (16) of
    the valid split (``eval_max_batches`` caps the batches), or None where
    the split is missing or empty. Emformer items are sorted by length and
    batched by 4 at the ladder's rung; vocoder crops by 4; Conan items one
    at a time, cut by ``_conan_valid_item``. None for the postnet, as in the
    JAX package."""
    from conan_tpu_torch.train import validation

    data_dir = hp["binary_data_dir"]
    if kind == "postnet" or not os.path.exists(f"{data_dir}/valid_lengths.npy"):
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_test(hp, device: str | torch.device | None = None, f0_noise_fn=None) -> dict:
    """``--infer`` for the acoustic model: convert the binarized test split
    chunkwise through the composed streaming engine (the work dir's Conan,
    ``emformer_ckpt``, ``vocoder_ckpt``) and write each wav to
    ``<work_dir>/generated_<resume_from_checkpoint or last>/<item>.wav``.

    Each item converts from its binarized mels: the source padded by
    repeating its last frame to whole chunks plus the ``rc`` lookahead
    frames, the reference not padded at all; its chunks go through
    ``stream_scan`` (on the card one CUDA graph per reference length, on the
    CPU the Python loop). Every ``test_consistency_interval`` items (8;
    0: never) the guard converts the item offline as well (the Emformer over
    the whole source, Conan's offline decode, the vocoder's ``apply``) and
    compares the wavs at ``test_consistency_atol`` (1e-3); on drift it
    writes the manifest with ``guard_passed: false`` and raises
    RuntimeError. ``infer_manifest.json`` has the JAX package's keys.

    With ``f0_gen: flow`` item i's initial noise is drawn from a
    ``torch.Generator`` seeded i, or taken from ``f0_noise_fn(i, T_pad)``
    ([1, T_pad, 1], T_pad the source padded to whole chunks). Returns what
    the run measured: per item its seconds of audio and of wall time, and
    the captures' wall ms (the card's)."""
    eng = build_engine(hp["work_dir"], hp["emformer_ckpt"], hp["vocoder_ckpt"], hp,
                       device=device)
    ds = ConanDataset(hp["binary_data_dir"], "test", hp)
    gen_dir = os.path.join(hp["work_dir"],
                           f"generated_{hp.get('resume_from_checkpoint', 'last')}")
    os.makedirs(gen_dir, exist_ok=True)
    check_every = int(hp.get("test_consistency_interval", 8))
    atol = float(hp.get("test_consistency_atol", 1e-3))
    hop, seg = eng.cfg.mel.hop, eng.cfg.seg
    manifest = {"work_dir": hp["work_dir"], "emformer_ckpt": hp["emformer_ckpt"],
                "vocoder_ckpt": hp["vocoder_ckpt"], "consistency_atol": atol, "items": []}
    stats = {"audio_s": [], "wall_s": []}
    checked = 0
    for i in range(len(ds)):
        s = ds[i]
        T = len(s["content"])
        T_pad = -(-T // seg) * seg
        src = torch.from_numpy(s["mel"][None]).to(eng.device)
        ref = torch.from_numpy(s["ref_mel"][None]).to(eng.device)
        if f0_noise_fn is not None:
            noise = f0_noise_fn(i, T_pad)
        else:
            noise = eng._f0_noise(1, T_pad, torch.Generator().manual_seed(i), None)
        _sync(eng.device)
        t0 = time.perf_counter()
        wav, _ = eng.stream_mels(src, ref, use_scan=True, f0_noise=noise)
        wav = wav[0].cpu().numpy()
        stats["wall_s"].append(time.perf_counter() - t0)
        stats["audio_s"].append(T * hop / hp["audio_sample_rate"])
        rec = {"item_name": str(s["item_name"]), "frames": int(T), "chunks": T_pad // seg,
               "guard": None}
        if check_every > 0 and i % check_every == 0:
            wav_off = eng.offline_mels(src, ref, f0_noise=noise)[0][0].cpu().numpy()
            diff = float(np.abs(wav - wav_off).max())
            rec["guard"] = {"max_abs_stream_vs_offline": diff, "ok": diff <= atol}
            if diff > atol:
                manifest["items"].append(rec)
                _write_infer_manifest(gen_dir, manifest, ok=False)
                raise RuntimeError(f"incremental-consistency drift on item {s['item_name']}: "
                                   f"max |stream - offline| = {diff:.3e}")
            checked += 1
        manifest["items"].append(rec)
        save_wav(os.path.join(gen_dir, f"{s['item_name']}.wav"), wav, hp["audio_sample_rate"])
        log.info("[%d/%d] %s", i + 1, len(ds), s["item_name"])
    manifest["guard_checked"] = checked
    _write_infer_manifest(gen_dir, manifest, ok=True)
    if checked:
        log.info("incremental-consistency guard: %d/%d items verified stream==offline",
                 checked, len(ds))
    stats["capture_ms"] = [c.capture_ms for c in eng._captured.values()]
    stats["gen_dir"] = gen_dir
    return stats


def _write_infer_manifest(gen_dir: str, manifest: dict, *, ok: bool) -> None:
    """``infer_manifest.json`` next to the wavs: the checkpoints, each item's
    name, frames and chunks with its guard result, and ``guard_passed``."""
    manifest["guard_passed"] = ok
    with open(os.path.join(gen_dir, "infer_manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def run_test_vocoder(hp, device: str | torch.device | None = None) -> None:
    """``--infer`` for a vocoder: copy-synthesis of the binarized test split
    by the work dir's generator (the registry's ``hp["vocoder"]``, "HifiGAN"
    where unset) into ``<work_dir>/generated_test``, each item's mel cut to
    whole chunks of ``infer_chunk_frames`` (4) and synthesized whole, with
    nothing padded. Every ``test_consistency_interval`` items (8) the guard
    streams the item through the generator's ``step`` chunk by chunk and
    compares it with the whole synthesis at ``test_consistency_atol``
    (1e-3), raising RuntimeError on drift; a generator that cannot stream
    raises ValueError before the first item unless the interval is 0. Runs
    in fp32 (the "exact" rung)."""
    device = resolve_device(device)
    work = hp["work_dir"]
    name = hp.get("vocoder") or "HifiGAN"
    gen = get_vocoder_cls(name)(HifiGanConfig.from_hparams(hp))
    check_every = int(hp.get("test_consistency_interval", 8))
    if check_every > 0 and not streamable(gen):
        raise ValueError(f"vocoder {name!r} (upsample {gen.cfg.upsample!r}) has no streaming "
                         "step for the stream-vs-offline guard: set "
                         "test_consistency_interval=0")
    params = fold_weight_norm(params_from_jax(load_ckpt_state(work, "params_g"), device))
    reader = RecordReader(f"{hp['binary_data_dir']}/test")
    gen_dir = os.path.join(work, "generated_test")
    os.makedirs(gen_dir, exist_ok=True)
    hop, seg = hp["hop_size"], int(hp.get("infer_chunk_frames", 4))
    atol = float(hp.get("test_consistency_atol", 1e-3))
    checked = 0
    with torch.inference_mode(), precision_scope("exact", device):
        for i in range(len(reader)):
            item = reader[i]
            mel = torch.from_numpy(np.asarray(item["mel"], np.float32)).to(device)
            T = mel.shape[0] // seg * seg
            wav = gen.apply(params, mel[None, :T])[0, :T * hop, 0]
            if check_every > 0 and i % check_every == 0:
                state = gen.init_state(1, device)
                chunks = []
                for t in range(0, T, seg):
                    y, state = gen.step(params, state, mel[None, t:t + seg])
                    chunks.append(y[0, :, 0])
                diff = float((torch.cat(chunks) - wav).abs().max()) if chunks else 0.0
                if diff > atol:
                    raise RuntimeError(f"incremental-consistency drift on item "
                                       f"{item['item_name']}: max |stream - offline| = "
                                       f"{diff:.3e}")
                checked += 1
            save_wav(os.path.join(gen_dir, f"{item['item_name']}.wav"), wav.cpu().numpy(),
                     hp["audio_sample_rate"])
            log.info("[%d/%d] %s", i + 1, len(reader), item["item_name"])
    if checked:
        log.info("incremental-consistency guard: %d/%d items verified stream==offline",
                 checked, len(reader))


def _train(argv: list, device, world: dist.World | None):
    """The CLI's work on one rank: rank 0 reads (and on a first run writes)
    the work dir's config, then the other ranks read it; ``--infer`` and
    ``--validate`` run on rank 0 alone."""
    main_rank = world is None or world.rank == 0
    hp = set_hparams(argv=argv) if main_rank else None
    dist.barrier(world)
    if hp is None:
        hp = set_hparams(argv=argv, save=False)
    if hp.get("infer") or hp.get("validate"):
        out = None
        if main_rank:
            if not hp.get("infer"):
                run_validate(hp, device)
            elif TASK_ALIASES.get(hp.get("task_cls", "conan")) == "vocoder":
                run_test_vocoder(hp, device)
            else:
                out = run_test(hp, device)
        dist.barrier(world)
        return out
    task, kind = build_task(hp, device=device, world=world)
    log.info("starting %s training in %s on %s (train_precision %s, rank %d of %d)", kind,
             hp["work_dir"], task.device, hp.get("train_precision", "highest"),
             0 if world is None else world.rank, 1 if world is None else world.size)
    Trainer(task, hp, hp["work_dir"], use_random_ref_after=use_random_ref_after(hp, kind)
            ).fit(build_train_iter(hp, kind, world),
                  build_valid_fn(hp, task, kind) if main_rank else None)


def _logging() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")


def _spawned_rank(rank: int, argv: list, world_size: int, port: int) -> None:
    """One rank of the per-card spawn: card ``rank``, NCCL over
    ``tcp://localhost:<port>``."""
    _logging()
    world = dist.init_distributed(f"cuda:{rank}", init_method=f"tcp://localhost:{port}",
                                  rank=rank, world_size=world_size)
    try:
        _train(argv, world.device, world)
    finally:
        dist.shutdown(world)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    """Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) this process is
    one rank: it joins the group (NCCL on ``cuda:LOCAL_RANK``, gloo with
    ``--device cpu``). Without it, training with no ``--device`` and more
    than one card visible starts one rank per card (the JAX trainer's mesh
    of every device, the original's per-GPU spawn); a rank that fails fails
    the run. Otherwise one process on one device, with no group."""
    _logging()
    argv = list(argv if argv is not None else sys.argv[1:])
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    ap.add_argument("--infer", action="store_true")
    ap.add_argument("--validate", action="store_true")
    known = ap.parse_known_args(argv)[0]
    device = known.device
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = dist.init_distributed(device)
        try:
            return _train(argv, world.device, world)
        finally:
            dist.shutdown(world)
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device is None and n_cards > 1 and not (known.infer or known.validate):
        torch.multiprocessing.spawn(_spawned_rank, args=(argv, n_cards, _free_port()),
                                    nprocs=n_cards, join=True)
        return
    return _train(argv, device, None)


if __name__ == "__main__":
    main()
