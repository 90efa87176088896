"""Batch voice conversion of recorded files (``conan_tpu/infer/run_vc.py``).

A JSON list of {source, reference, output} triples goes through the engine,
one pair at a time, with an error report per pair and an RTF summary:

    python -m conan_tpu_torch.infer.run_vc --pairs pairs.json \
        --conan_dir checkpoints/conan --emformer_dir checkpoints/emformer \
        --vocoder_dir checkpoints/hifigan_vc [--offline] \
        [--serving_precision exact|high|fast] [--hparams k=v,...] [--device cpu]

Each pair runs ``infer_once(use_scan=True, bucket_lengths=True)`` (the
captured chunk loop on the card), or ``infer_offline(bucket_lengths=True)``
with ``--offline``; the source lengths go onto the power-of-two ladder, so a
batch of many lengths needs few captures (the reference is never padded:
one capture per distinct reference length). ``--hparams`` puts dotted overrides on
the acoustic checkpoint's ``config.yaml`` (``vocoder_denoise_c=0.01``,
``serving_precision=high``). The device is the CUDA card unless
``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from conan_tpu_torch.device import resolve_device

log = logging.getLogger("conan_tpu_torch.run_vc")


def save_wav(path: str, wav: np.ndarray, sr: int) -> None:
    from scipy.io import wavfile

    wav = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767).astype(np.int16))


def postprocess(wav: np.ndarray, mel_cfg, denoise_c: float,
                device: str | torch.device | None = None) -> np.ndarray:
    """Spectral subtraction after the vocoder when ``denoise_c > 0``, on
    ``device`` (None: the CUDA card; raises without one) in fp32. The wav
    is zero-padded to a power-of-two number of hops (at least 64) before the
    denoise and cut back after it, as the JAX package does; the padding
    changes the last frames' STFT, so it is part of the result."""
    device = resolve_device(device)
    if denoise_c <= 0:
        return wav
    from conan_tpu_torch.audio.denoise import spectral_denoise
    from conan_tpu_torch.ops.precision import precision_scope

    n = len(wav)
    hops = max(64, -(-n // mel_cfg.hop))
    bucket = 64
    while bucket < hops:
        bucket *= 2
    padded = torch.from_numpy(np.pad(wav.astype(np.float32), (0, bucket * mel_cfg.hop - n)))
    with torch.inference_mode(), precision_scope("exact", device):
        out = spectral_denoise(padded[None].to(device), v=denoise_c, n_fft=mel_cfg.n_fft,
                               hop=mel_cfg.hop, win_length=mel_cfg.win_length)
    return out[0, :n].cpu().numpy()


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", required=True, help="JSON list of {source, reference, output}")
    ap.add_argument("--conan_dir", required=True)
    ap.add_argument("--emformer_dir", required=True)
    ap.add_argument("--vocoder_dir", required=True)
    ap.add_argument("--offline", action="store_true",
                    help="the offline composition of the three stages instead of streaming")
    ap.add_argument("--serving_precision", default=None, choices=("exact", "high", "fast"),
                    help="the rung of the acoustic model and vocoder (the Emformer runs fp32 "
                         "on every rung); default: the acoustic checkpoint's "
                         "serving_precision hparam, else exact")
    ap.add_argument("--hparams", default="",
                    help="overrides of the acoustic checkpoint's config.yaml, "
                         "'k=v,a.b=v' (e.g. vocoder_denoise_c=0.01)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    from conan_tpu_torch.config import set_hparams
    from conan_tpu_torch.data.binarizer import load_wav
    from conan_tpu_torch.infer.build import build_engine
    from conan_tpu_torch.utils.async_save import AsyncSaver

    cfg_path = os.path.join(args.conan_dir, "config.yaml")
    hp = set_hparams(cfg_path if os.path.exists(cfg_path) else "", args.hparams)
    eng = build_engine(args.conan_dir, args.emformer_dir, args.vocoder_dir, hp=hp,
                       serving_precision=args.serving_precision, device=args.device)
    sr = eng.cfg.mel.sample_rate
    denoise_c = float(hp.get("vocoder_denoise_c", 0.0) or 0.0)

    with open(args.pairs) as f:
        pairs = json.load(f)
    saver = AsyncSaver()
    ok, failed = 0, []
    total_audio, total_wall = 0.0, 0.0
    try:
        for i, pair in enumerate(pairs):
            try:
                src = load_wav(pair["source"], sr)
                ref = load_wav(pair["reference"], sr)
                t0 = time.perf_counter()
                if args.offline:
                    wav = eng.infer_offline(src, ref, bucket_lengths=True)[0]
                else:
                    wav = eng.infer_once(src, ref, use_scan=True, bucket_lengths=True)[0]
                wav = postprocess(wav, eng.cfg.mel, denoise_c, eng.device)
                wall = time.perf_counter() - t0
                out_path = (pair.get("output")
                            or os.path.splitext(pair["source"])[0] + "_vc.wav")
                os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
                saver.submit(save_wav, out_path, wav, sr)
                total_audio += len(wav) / sr
                total_wall += wall
                ok += 1
                log.info("[%d/%d] %s  (%.2fs audio, %.2fs wall)", i + 1, len(pairs), out_path,
                         len(wav) / sr, wall)
            except Exception:  # one bad pair must not stop the batch
                failed.append(pair)
                log.exception("[%d/%d] FAILED %s", i + 1, len(pairs), pair)
    finally:
        saver.close()
    log.info("done: %d ok, %d failed, RTF=%.4f", ok, len(failed),
             total_wall / max(total_audio, 1e-9))
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
