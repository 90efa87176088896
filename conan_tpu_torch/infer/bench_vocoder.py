"""Vocoder micro-harness: single-chunk latency and an incremental-consistency
check (``conan_tpu/infer/bench_vocoder.py``; the reference's harnesses in
``tasks/vocoder/hifigan.py:556-632`` and ``:277-444``).

    python -m conan_tpu_torch.infer.bench_vocoder [--ckpt_dir DIR] [--chunks 50]
        [--chunk_frames 4] [--device cpu]

Builds the causal generator from a vocoder checkpoint dir (its
``config.yaml`` and newest checkpoint's ``params_g``), or from a random init
seeded 0, on the card unless ``--device`` says otherwise. It times ``step``
on one chunk of ``chunk_frames`` mel frames ``chunks`` times after a warm-up
step (CUDA events on the card, the host's clock on the CPU; the first three
dropped) and prints the p50, mean and RTF line; then it runs the same mel
in chunks of ``chunk_frames`` and of twice that and prints the largest
difference between the two with OK (under 1e-4) or FAIL. A FAIL exits with
code 1.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

CONSISTENCY_ATOL = 1e-4
DROP_FIRST = 3


def _generator(ckpt_dir: str, device: torch.device):
    """(HifiGanGenerator, params, sample rate) from ``ckpt_dir``, or the
    default config with seeded random weights when it is empty."""
    from conan_tpu_torch.checkpoint import load_ckpt_state, params_from_jax, tree_map
    from conan_tpu_torch.config import HParams, load_config
    from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig, HifiGanGenerator

    if not ckpt_dir:
        gen = HifiGanGenerator(HifiGanConfig())
        params = gen.init(torch.Generator().manual_seed(0))
        return gen, tree_map(lambda x: x.to(device), params), 16000
    hp = HParams(load_config(os.path.join(ckpt_dir, "config.yaml")))
    gen = HifiGanGenerator(HifiGanConfig.from_hparams(hp))
    params = params_from_jax(load_ckpt_state(ckpt_dir, "params_g"), device)
    return gen, params, int(hp.get("audio_sample_rate", 16000))


def _chunked(gen, params, mel: torch.Tensor, frames: int) -> torch.Tensor:
    """The generator's output for ``mel`` fed in chunks of ``frames``."""
    state = gen.init_state(mel.shape[0], mel.device)
    outs = []
    for s in range(0, mel.shape[1], frames):
        y, state = gen.step(params, state, mel[:, s:s + frames])
        outs.append(y)
    return torch.cat(outs, 1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_dir", default="", help="vocoder checkpoint dir (random init if empty)")
    ap.add_argument("--chunks", type=int, default=50)
    ap.add_argument("--chunk_frames", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    if args.chunks <= DROP_FIRST:
        ap.error(f"--chunks must be more than {DROP_FIRST}")

    from conan_tpu_torch.device import resolve_device
    from conan_tpu_torch.ops.precision import precision_scope
    from conan_tpu_torch.utils.profiling import LatencyHistogram

    device = resolve_device(args.device)
    gen, params, sr = _generator(args.ckpt_dir, device)
    cf = args.chunk_frames
    T = args.chunks * cf
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, T, gen.cfg.num_mels)).astype(np.float32)).to(device)
    cuda = device.type == "cuda"

    with torch.inference_mode(), precision_scope("exact", device):
        state = gen.init_state(1, device)
        _, state = gen.step(params, state, mel[:, :cf])
        hist = LatencyHistogram()
        for i in range(args.chunks):
            s = (i % (args.chunks - 1)) * cf
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                _, state = gen.step(params, state, mel[:, s:s + cf])
                end.record()
                end.synchronize()
                hist.record(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                _, state = gen.step(params, state, mel[:, s:s + cf])
                hist.record((time.perf_counter() - t0) * 1e3)
        lat = hist.summary(drop_first=DROP_FIRST)
        chunk_ms = cf * gen.cfg.total_stride / sr * 1e3
        print(f"vocoder single-chunk ({cf} frames = {chunk_ms:.0f} ms audio): "
              f"p50 {lat['p50_ms']:.3f} ms, mean {lat['mean_ms']:.3f} ms, "
              f"RTF {lat['p50_ms'] / chunk_ms:.4f}")

        y_a = _chunked(gen, params, mel, cf)
        y_b = _chunked(gen, params, mel, 2 * cf)
        diff = float(torch.max(torch.abs(y_a - y_b)))
    ok = diff < CONSISTENCY_ATOL
    print(f"incremental-consistency ({cf} vs {2 * cf} frame chunks) "
          f"max|diff| = {diff:.3e} ({'OK' if ok else 'FAIL'})")
    sys.stdout.flush()
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
