#!/usr/bin/env python3
"""Measurements of the PyTorch port's training rungs (ops/precision.py),
beside chip_smoke.py, which checks each task's rung steps as they ship.

    python3 tools/torch_rung_lab.py conditioning     # on the CPU
    python3 tools/torch_rung_lab.py conan-cudnn      # on a CUDA card

conditioning  egs/soak_r5/vocoder.yaml's step at the card tests' width
              (upsample_initial_channel 32, seed 0, B=2 x 8 frames) on the
              CPU, at "highest" in fp32 and at "default" (there the exact
              fp32 product of bf16-rounded operands), each against the same
              step in float64: the relative L2 of the gradient tree (the
              optimizers' first moments), the generator's and the
              discriminators' apart. Shows how far rounding alone moves the
              vocoder's gradient at random init.
conan-cudnn   egs/soak_r5/conan.yaml's step at full width (B=24 x 1496, a
              synthesized batch, step 6: every schedule gate on) at
              "default" and "highest", with cuDNN's heuristic algorithm
              choice and with cudnn.benchmark, in turns (off, on, on, off):
              ms of 3 steps after 2 warm ones, by CUDA events.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from conan_tpu_torch.checkpoint import tree_leaves, tree_map  # noqa: E402
from conan_tpu_torch.config import load_config  # noqa: E402
from conan_tpu_torch.train.tasks import ConanTask, VocoderTask  # noqa: E402


def _rel(leaves, leaves_64) -> float:
    a = torch.cat([x.double().ravel() for x in leaves])
    b = torch.cat([x.double().ravel() for x in leaves_64])
    return float((a - b).norm() / b.norm())


def conditioning() -> None:
    hp = dict(load_config(os.path.join(ROOT, "egs", "soak_r5", "vocoder.yaml")),
              upsample_initial_channel=32)
    rng = np.random.default_rng(3)
    batch = {"mels": (rng.standard_normal((2, 8, 80)) - 4).astype(np.float32),
             "wavs": (rng.standard_normal((2, 8 * 320)) * 0.1).astype(np.float32)}
    task = lambda rung: VocoderTask(dict(hp, train_precision=rung), device="cpu")  # noqa: E731
    state = task("highest").init_state(torch.Generator().manual_seed(0))
    new_64, _ = task("highest").train_step(
        tree_map(lambda t: t.double() if t.is_floating_point() else t, state),
        {k: v.astype(np.float64) for k, v in batch.items()})
    parts = {"G": lambda st: tree_leaves(st["opt_g"]["mu"]),
             "D": lambda st: tree_leaves(st["opt_d"]["mu"])}
    for rung in ("highest", "default"):
        new, _ = task(rung).train_step(state, batch)
        print(f"{rung}: gradient tree rel L2 from float64 "
              f"{_rel(parts['G'](new) + parts['D'](new), parts['G'](new_64) + parts['D'](new_64)):.4g}"
              + "".join(f", {p} {_rel(f(new), f(new_64)):.4g}" for p, f in parts.items()),
              flush=True)


def conan_cudnn() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("conan-cudnn needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hp = load_config(os.path.join(ROOT, "egs", "soak_r5", "conan.yaml"))
    hp.update(vq_start=1, forcing=2, disc_start_steps=3, random_speaker_steps=5)
    rng = np.random.default_rng(0)
    B, T, Tr = 24, 1496, 1472
    batch = {"content": rng.integers(0, 100, (B, T)),
             "mels": (rng.standard_normal((B, T, 80)) * 0.5 - 4).astype(np.float32),
             "ref_mels": (rng.standard_normal((B, Tr, 80)) * 0.5 - 4).astype(np.float32),
             "f0": (rng.standard_normal((B, T)) * 0.3 + 7.5).astype(np.float32),
             "uv": (rng.random((B, T)) < 0.2).astype(np.float32)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rung in ("default", "highest"):
        task = ConanTask(dict(hp, train_precision=rung))
        state = task.init_state(torch.Generator().manual_seed(0))
        state["step"] = torch.tensor(6, dtype=torch.int32, device="cuda")
        state["vq_state"]["initialized"] = torch.ones((), device="cuda")
        for bench in (False, True, True, False):
            torch.backends.cudnn.benchmark = bench
            for _ in range(2):
                task.train_step(state, batch, gen, use_random_ref=True)
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            for i in range(3):
                task.train_step(state, batch, gen, use_random_ref=True)
                ev[i + 1].record()
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
            print(f"conan step {rung} cudnn.benchmark={bench}: ms "
                  f"{[round(x, 2) for x in ms]} median {np.median(ms):.2f}", flush=True)
    torch.backends.cudnn.benchmark = False


if __name__ == "__main__":
    cmds = {"conditioning": conditioning, "conan-cudnn": conan_cudnn}
    if len(sys.argv) != 2 or sys.argv[1] not in cmds:
        raise SystemExit(f"usage: {sys.argv[0]} {'|'.join(cmds)}")
    cmds[sys.argv[1]]()
