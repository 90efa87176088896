#!/usr/bin/env python3
"""Measurements behind two repairs of the port's vocoder training step,
beside chip_smoke.py, which checks the step as it ships. Both need a CUDA
card.

    python3 tools/torch_vocoder_grad_lab.py pool
    python3 tools/torch_vocoder_grad_lab.py accumulate

pool        The MSD's average pooling (AvgPool1d(4, 2, padding=1)) on a
            one-channel wav batch [2, 8000, 1] and on its pooled [2, 4000,
            1], in float64, three times each: ``F.avg_pool1d`` on the
            [B, 1, T] view (the port's pooling until it was replaced) and
            the ``unfold`` mean of ``discriminators._avg_pool1d``, the card
            against the CPU, forward and input gradient (relative L2). Then
            the conditional MSD's input gradient, scale by scale, card
            against CPU in float64 (plain grouped conv, cuDNN off).
accumulate  egs/hifigan_shuffle.yaml with the conditional and spectrogram
            discriminators on, at full width on the card: wall ms (the card
            drained before and after, 5 calls after a warm one) of the
            inner AdamW update of G and D (clip, Adam, decay, LR: what
            ``Accumulate`` ran on every mini-step before it ran it on the
            k-th only), of ``Accumulate.update`` on a mini-step that makes
            no update, and of the running mean alone; each parameter leaf
            stands in for its gradient.
"""

from __future__ import annotations

import os
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from conan_tpu_torch.checkpoint import tree_leaves, tree_map  # noqa: E402
from conan_tpu_torch.config import load_config  # noqa: E402


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.cpu().double(), b.cpu().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def pool() -> None:
    from conan_tpu_torch.models.vocoder.discriminators import (MultiScaleDiscriminator,
                                                               _avg_pool1d)
    from conan_tpu_torch.ops import conv as conv_ops
    from conan_tpu_torch.ops.groupconv import grouped_conv1d_reference

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    routes = {"F.avg_pool1d on the [B, 1, T] view":
              lambda x: F.avg_pool1d(x.transpose(1, 2), 4, 2, padding=1).transpose(1, 2),
              "_avg_pool1d (unfold)": _avg_pool1d}
    for T in (8000, 4000):
        for trial in range(3):
            x0 = torch.randn(2, T, 1, dtype=torch.float64, generator=gen)
            r0 = torch.randn(2, T // 2, 1, dtype=torch.float64, generator=gen)
            for name, fn in routes.items():
                out = []
                for device in (dev, torch.device("cpu")):
                    x = x0.to(device).requires_grad_(True)
                    y = fn(x)
                    g, = torch.autograd.grad((y * r0.to(device)).sum(), x)
                    out.append((y.detach(), g))
                print(f"T={T} trial {trial} {name}: forward card vs CPU "
                      f"{_rel(out[0][0], out[1][0]):.3g}, input gradient "
                      f"{_rel(out[0][1], out[1][1]):.3g}", flush=True)

    msd = MultiScaleDiscriminator(use_cond=True)
    params = tree_map(lambda t: t.double(), msd.init(torch.Generator().manual_seed(0)))
    y0 = 0.3 * torch.randn(2, 8000, 1, dtype=torch.float64, generator=gen)
    mel = torch.randn(2, 25, 80, dtype=torch.float64, generator=gen)

    def input_grads(device):
        x = y0.to(device).requires_grad_(True)
        outs, _ = msd.forward(tree_map(lambda t: t.to(device), params), x, mel.to(device))
        return [torch.autograd.grad(torch.mean((1 - o) ** 2), x, retain_graph=True)[0]
                for o in outs]

    conv_ops.groupconv = grouped_conv1d_reference
    with torch.backends.cudnn.flags(enabled=False):
        card, cpu = input_grads(dev), input_grads("cpu")
    print("conditional MSD input gradient, card vs CPU in float64, by scale: "
          + ", ".join(f"{_rel(a, b):.3g}" for a, b in zip(card, cpu)), flush=True)


def _wall_ms(fn, n: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def accumulate() -> None:
    from conan_tpu_torch.train.tasks import VocoderTask

    hp = load_config(os.path.join(ROOT, "egs", "hifigan_shuffle.yaml"))
    hp.update(use_cond_disc=True, use_spec_disc=True, use_fm_loss=True,
              accumulate_grad_batches=2)
    task = VocoderTask(hp)
    state = task.init_state(torch.Generator().manual_seed(0))
    pairs = [(task.opt_g, state["opt_g"], state["params_g"]),
             (task.opt_d, state["opt_d"], state["params_d"])]
    n_leaves = sum(len(tree_leaves(p)) for _o, _s, p in pairs)
    inner = _wall_ms(lambda: [o.inner.update(p, st["inner"], p) for o, st, p in pairs])
    update = _wall_ms(lambda: [o.update(p, st, p) for o, st, p in pairs])
    mean = _wall_ms(lambda: [[a + (g - a) / (st["mini_step"] + 1) for a, g in zip(
        tree_leaves(st["acc"]), tree_leaves(p))] for _o, st, p in pairs])
    print(f"{torch.cuda.get_device_name(0)}; G + D {n_leaves} leaves: inner AdamW update "
          f"{inner:.3f} ms wall, Accumulate.update on a mini-step without an update "
          f"{update:.3f} ms, the running mean alone {mean:.3f} ms", flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in ("pool", "accumulate"):
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    {"pool": pool, "accumulate": accumulate}[sys.argv[1]]()
