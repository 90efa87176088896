#!/usr/bin/env python3
"""Smoke run of the PyTorch port (conan_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--trained conan,emf,voc]

Phases, one line each (the train phase several), then a JSON line of kernels
and the result line:

  1. device   the card's name and power limit (nvidia-smi); exits 1 without CUDA
  2. build    one nvcc builds every kernel in conan_tpu_torch/csrc (sm_90a)
  3. kernels  each serving kernel against its plain PyTorch version on the
              card, at the main path's shapes: max abs error, times (CUDA
              events for the wrapper call, torch.profiler for the kernel
              alone), bound; a call launches once and allocates only its
              output
  4. main     build_engine(...).infer_once then infer_offline at the full r5
              production geometry (egs/soak_r5/*.yaml: 6-layer Emformer,
              hidden-256 Conan, 512-channel causal shuffle HiFi-GAN) in exact
              precision: streaming ≡ offline to atol 1e-4 with equal codes,
              every kernel of the path launched; per-chunk ms, RTF, memory
              then torch.profiler over 16 chunk steps: device busy share,
              kernels per chunk, host and device ms per stage
  5. train    the vocoder GAN train step at production width
              (egs/soak_r5/vocoder.yaml with train_precision: highest set
              over it, i.e. fp32 "exact"): the training kernels (K2 on the
              MSD's 15 grouped geometries, K1's GAN form at its three n_fft)
              against their plain versions in value and gradient; then
              VocoderTask + Trainer.fit for 5 steps at B = 18: loss terms,
              skipped updates, ms per step, peak memory, kernel launches per
              step against the count the code predicts, and a profiled step;
              then one step at B = 2 on the card against the same step on
              the CPU; then K2 on each grouped geometry beside cuDNN, its
              bound and cuDNN's backward there, and K1's GAN form's times
  6. {"kernels": [...]}
  7. {"ok": true, "device": {...}}

The weights are random, made from --seed and written as checkpoint dirs
under build/; the audio is synthesized from the seed. --trained names the
stages (conan, emf, voc) that load the trained checkpoints/soak_r5_<stage>/
deploy weights instead; the audio then is two of the r5 validation wavs.
Imports nothing of JAX or conan_tpu.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import wave

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from conan_tpu_torch.audio.mel import MelConfig
from conan_tpu_torch.checkpoint import tree_leaves, tree_map
from conan_tpu_torch.config import load_config
from conan_tpu_torch.infer.build import build_engine, write_random_checkpoints
from conan_tpu_torch.models.vocoder.discriminators import DiscriminatorS
from conan_tpu_torch.ops import native
from conan_tpu_torch.ops.groupconv import groupconv, grouped_conv1d_reference
from conan_tpu_torch.ops.logmel import (GAN_CLIP, GAN_EPS, _gan_vjp, gan_pad, logmel,
                                        logmel_gan, logmel_gan_reference, logmel_reference)
from conan_tpu_torch.train.losses import gan_mel_configs
from conan_tpu_torch.train.tasks import VocoderTask
from conan_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 16000
STAGES = ("conan", "emf", "voc")  # build_engine's order
# Published H100 SXM peaks (dense): fp32 outside the tensor cores, TF32 on
# them, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# K1 against its plain version: both fp32 over the same window and
# filterbank, the DFT computed another way (the kernel's radix-2 FFT against
# cuBLAS's dense DFT product), then log10 of the mel sums; the bound the JAX
# package holds its Pallas kernel to against XLA (tests/test_pallas_stft.py).
# The dense fp32 DFT is the less exact of the two: at a mel whose only bin
# happens to be small its error reaches 1.5e-3 in the log, where the FFT's
# is 5.6e-5 (PERF.md §6). So an element past the bound from the fp32
# plain version is held to the same bound from the plain version run in
# float64. K1-GAN's dwav weighs each mel by 1/mel, so it reads those small
# bins most; there even the plain version's exact value (float64 over its
# basis, whose window x cos products are rounded to fp32) is 1.4e-4 from the
# exact windowed DFT at n_fft 512. So a dwav past its bound from the fp32
# plain version is held to the same bound from the exact value of the
# function K1 computes (logmel_gan_exact), as the train-step check
# below holds its leaves to a float64 step.
LOGMEL_ATOL, LOGMEL_RTOL = 2e-4, 1e-4
# streaming against offline waveforms (tests/test_streaming_engine.py)
STREAM_ATOL = 1e-4
# The training kernels against their plain versions: values as K1 above (fp32
# sums in another order); gradients (dx and dw of K2 through its autograd
# Function, dwav of K1's analytic backward) a relative L2 error of 1e-4 per
# tensor. An absolute bound does not scale with the step's shapes: K2's dw at
# scale 1 sums 18 · 4000 products, and both sides start from outputs that
# differ in their fp32 rounding.
GRAD_REL = 1e-4
# The card's train step (kernels K1 and K2, cuDNN) against the CPU's (plain
# versions) from the same state and batch: loss terms rtol 1e-4, gradient
# leaves a relative L2 error of 1e-3 (fp32 sums in other orders through the
# generator, the MPD and the MSD). The CPU step runs with oneDNN off: ATen's
# oneDNN fp32 convolution backward moves the MSD's first-layer weight
# gradients some 1e-3 from a float64 step where cuDNN stays within 1.2e-6
# (tests/test_torch_vocoder_train.py runs its port side the same way). Even
# so a D leaf came within 6% of 1e-3, so a leaf past 1e-3 from the CPU's fp32
# is held instead to 1e-3 from the same step run in float64 on the CPU.
STEP_RTOL, STEP_GRAD_REL = 1e-4, 1e-3
TRAIN_B, TRAIN_STEPS, CHECK_B = 18, 5, 2


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, key: str, iters: int = 20) -> float:
    """Device time of one launch of the kernel whose name holds ``key``
    (``fn`` launches it once), by torch.profiler over ``iters`` calls after a
    warm one: the mean over the launches the profiler recorded (it may miss
    one at the window's edge). Beside ``cuda_ms``, which times the whole
    wrapper call (its other launches and, for a kernel of a few µs, the
    host), this is the kernel alone."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and key in e.key]
    count = sum(e.count for e in evs)
    if not iters // 2 <= count <= iters:
        fail(f"profiler saw {count} launches of {key} in {iters} calls")
    return sum(e.self_device_time_total for e in evs) / 1e3 / count


def logmel_bound_ms(B: int, T: int, n_frames: int, cfg: MelConfig,
                    melw: torch.Tensor) -> tuple[float, str]:
    """Least time the card could take for one log-mel call, the larger of two:
    the bytes the function must move (wav and window read once, the
    filterbank's nonzero weights and each mel's first and last bin read
    once, log-mel written once) over HBM, and the fp32 operations it needs per
    frame over the fp32 peak. The operations are those of a real FFT
    (2.5·n·log2 n), the window (n), the magnitude (re²+im², sqrt: 4 a bin),
    the mel product over the filterbank's nonzero weights (2 each) and the
    clip and log (2 a mel); not those of the kernel's dense DFT product."""
    n_bins = cfg.n_fft // 2 + 1
    nnz = int((melw != 0).sum())
    bytes_ = 4 * (B * T + cfg.win_length + nnz + 2 * cfg.n_mels + B * n_frames * cfg.n_mels)
    flops = B * n_frames * (2.5 * cfg.n_fft * math.log2(cfg.n_fft) + cfg.n_fft + 4 * n_bins
                            + 2 * nnz + 2 * cfg.n_mels)
    t_bytes, t_ops = bytes_ / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def groupconv_bound_ms(B: int, T: int, ci: int, co: int, k: int, s: int, g: int,
                       pad: int) -> tuple[float, str, str]:
    """Least time for one grouped conv at fp32 accuracy, the larger of two:
    the input, weights and output once over HBM, and its true FLOPs (2 per
    multiply-add of the grouped product, not a block-diagonal packing's) on
    the faster of two fp32-accurate routes, FMA at the fp32 peak or the
    three-product tf32 split (3 × the FLOPs) at the TF32 peak. Returns (ms,
    "bytes" or "operations", the route)."""
    t_out = (T + 2 * pad - k) // s + 1
    flops = 2 * B * t_out * co * (ci // g) * k
    bytes_ = 4 * (B * T * ci + co * (ci // g) * k + B * t_out * co)
    routes = {"fp32 FMA": flops / PEAK_FP32_FLOPS, "3xTF32": 3 * flops / PEAK_TF32_FLOPS}
    route = min(routes, key=routes.get)
    t_bytes, t_ops = bytes_ / PEAK_HBM_BYTES, routes[route]
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes", "HBM"
    return 1e3 * t_ops, "operations", route


def library_logmel_gan(wav: torch.Tensor, cfg: MelConfig, window: torch.Tensor,
                       melw: torch.Tensor) -> torch.Tensor:
    """K1's GAN form as a PyTorch library call chain (the yardstick only):
    clip and reflect pad, torch.stft(center=False), sqrt(pow + 1e-9), matmul, ln."""
    spec = torch.view_as_real(torch.stft(gan_pad(wav, cfg), cfg.n_fft, cfg.hop, cfg.win_length,
                                         window, center=False, return_complex=True))
    mag = torch.sqrt(spec.pow(2).sum(-1) + 1e-9)
    return torch.log(torch.clamp(mag.transpose(1, 2) @ melw, min=1e-5))


def library_logmel(wav: torch.Tensor, cfg: MelConfig, window: torch.Tensor,
                   melw: torch.Tensor) -> torch.Tensor:
    """The same function as one PyTorch library call chain, timed as the
    yardstick only: torch.stft, abs, matmul, log10."""
    spec = torch.stft(wav, cfg.n_fft, cfg.hop, cfg.win_length, window, center=True,
                      pad_mode="constant", return_complex=True).abs()
    return torch.log10(torch.clamp(spec.transpose(1, 2) @ melw, min=1e-6))


def synth_wav(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """A voiced-like test signal: harmonics of a gliding 100-220 Hz f0 with
    a syllable envelope, plus noise."""
    t = np.arange(int(seconds * SR)) / SR
    f0 = 160 + 60 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t + rng.uniform(0, 6))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(np.sin(k * phase) / k for k in range(1, 20))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    return (0.1 * env * voiced + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def read_wav(path: str) -> np.ndarray:
    with wave.open(path, "rb") as f:
        data = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    return data.astype(np.float32) / 32768.0


def msd_grouped_geometries(T: int) -> list[tuple]:
    """(scale, input length, ci, co, k, stride, groups, pad) of every grouped
    conv the MSD runs on a wav of T samples: 5 a scale, at T, T/2 and T/4."""
    geoms, t_scale = [], T
    for scale in range(3):
        if scale:
            t_scale = (t_scale + 2 - 4) // 2 + 1     # AvgPool1d(4, 2, padding=1)
        t = t_scale
        for ci, co, k, s, g, pd in DiscriminatorS.LAYERS:
            if g > 1:
                geoms.append((scale + 1, t, ci, co, k, s, g, pd))
            t = (t + 2 * pd - k) // s + 1
    return geoms


def groupconv_times(geoms: list[tuple], gen: torch.Generator, dev: torch.device) -> list[dict]:
    """K2's time on each grouped geometry at B = TRAIN_B, beside the plain
    version, cuDNN's F.conv1d and the bound, and its backward's (cuDNN dx and
    dw through _GroupConvFunction.backward: dx + dw as in the discriminator
    step, dx alone as in the generator step). One dict a geometry."""
    rows = []
    for scale, t, ci, co, k, s, g, pd in geoms:
        x = torch.randn(TRAIN_B, t, ci, generator=gen).to(dev)
        w = ((torch.rand(co, ci // g, k, generator=gen) * 2 - 1) / (k * ci // g) ** 0.5).to(dev)
        x_cf = x.transpose(1, 2).contiguous()
        k2 = dict(stride=s, padding=(pd, pd), groups=g)
        with torch.no_grad():
            row = {"ms": cuda_ms(lambda: groupconv(x, w, **k2)),
                   "kernel_device_ms": kernel_device_ms(lambda: groupconv(x, w, **k2),
                                                        "groupconv_tf32x3_kernel"),
                   "plain_ms": cuda_ms(lambda: grouped_conv1d_reference(x, w, **k2)),
                   "library_ms": cuda_ms(lambda: F.conv1d(x_cf, w, stride=s, padding=pd,
                                                          groups=g))}
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y_both, y_dx = groupconv(xg, wg, **k2), groupconv(xg, w, **k2)
        gy = torch.randn_like(y_both)
        row["bwd_dx_dw_ms"] = cuda_ms(
            lambda: torch.autograd.grad(y_both, (xg, wg), gy, retain_graph=True), iters=20)
        row["bwd_dx_ms"] = cuda_ms(
            lambda: torch.autograd.grad(y_dx, xg, gy, retain_graph=True), iters=20)
        row["bound_ms"], row["bound_by"], row["route"] = groupconv_bound_ms(
            TRAIN_B, t, ci, co, k, s, g, pd)
        rows.append(row)
        print(f"train groupconv geometry: scale {scale} {ci}->{co} s{s} g{g} B={TRAIN_B} "
              f"T={t}: kernel {row['ms']:.4f} ms (device {row['kernel_device_ms']:.4f} ms), "
              f"cuDNN F.conv1d (TF32 off) "
              f"{row['library_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4g} ms by {row['bound_by']} ({row['route']}); backward "
              f"(cuDNN) dx+dw {row['bwd_dx_dw_ms']:.4f} ms, dx {row['bwd_dx_ms']:.4f} ms",
              flush=True)
    return rows


def value_and_grads(fn, *inputs):
    """fn's output and the gradients of sum(sin(output)) for each input."""
    inputs = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*inputs)
    torch.sin(out).sum().backward()
    return out.detach(), [x.grad for x in inputs]


def compare(name: str, got, want, atol: float, rtol: float) -> float:
    if got.shape != want.shape or not torch.allclose(got, want, atol=atol, rtol=rtol):
        fail(f"{name} disagrees with its plain version: shapes {tuple(got.shape)} / "
             f"{tuple(want.shape)}, max abs {float((got - want).abs().max()):.3g}")
    return float((got - want).abs().max())


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm().clamp(min=1e-30))


def compare_logmel(name: str, got, want, exact) -> tuple[float, str]:
    """K1's output ``got`` against its fp32 plain version ``want`` at
    LOGMEL_ATOL / LOGMEL_RTOL; the elements past that are held to the same
    bound from ``exact()``, the plain version run in float64. Returns the max
    abs difference from the fp32 plain version and a note on the elements
    held to float64 ("" if none)."""
    if got.shape != want.shape:
        fail(f"{name} shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = float((got - want).abs().max())
    past = ~torch.isclose(got, want, atol=LOGMEL_ATOL, rtol=LOGMEL_RTOL)
    if not past.any():
        return err, ""
    want64 = exact()
    ok64 = torch.isclose(got.double(), want64, atol=LOGMEL_ATOL, rtol=LOGMEL_RTOL)
    note = (f"{name}: {int(past.sum())} elements past the bound from the fp32 plain version "
            f"(max abs {err:.3g}), from float64 max abs "
            f"{float((got.double() - want64)[past].abs().max()):.3g} (fp32 plain from float64 "
            f"{float((want.double() - want64)[past].abs().max()):.3g})")
    if not ok64[past].all():
        fail(f"{name} disagrees with its plain version in fp32 and in float64: {note}")
    return err, note


def logmel_gan_exact(wav: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """The function K1's GAN form computes, in float64: the frames times the
    fp32 window K1 uses, a dense DFT with a float64 basis (the plain
    version's basis rounds each window x cos product to fp32), then
    sqrt(re² + im² + eps), the filterbank and ln(max(., clip))."""
    window = logmel_gan.tables(cfg, wav.device)[0].double()
    n = torch.arange(cfg.n_fft, device=wav.device, dtype=torch.float64)
    angle = 2 * math.pi * n[:, None] * n[None, :cfg.n_fft // 2 + 1] / cfg.n_fft
    frames = gan_pad(wav.double(), cfg).unfold(-1, cfg.n_fft, cfg.hop) * window
    re, im = frames @ torch.cos(angle), frames @ -torch.sin(angle)
    melw = logmel_gan.dense_constants(cfg, wav.device)[1].double()
    return torch.log(torch.clamp(torch.sqrt(re * re + im * im + GAN_EPS) @ melw, min=GAN_CLIP))


def logmel_gan_route_grad(wav: torch.Tensor, cfg: MelConfig, out: torch.Tensor) -> torch.Tensor:
    """dwav of sum(sin(ln-mel)) by K1-GAN's own route (gan_pad, then the
    analytic backward in fp32) for the forward output ``out``: with
    ``logmel_gan_exact``'s, the gradient that route gives for an exact
    forward."""
    w = wav.detach().clone().requires_grad_(True)
    padded = gan_pad(w, cfg)
    basis, melw = logmel_gan.dense_constants(cfg, wav.device)
    g = torch.cos(out.float())
    return torch.autograd.grad(padded, w, _gan_vjp(padded.detach(), g, cfg, basis, melw))[0]



def compare_grad(name: str, got, want) -> float:
    err = rel_l2(got, want)
    if got.shape != want.shape or not err <= GRAD_REL:
        fail(f"{name} disagrees with its plain version: shapes {tuple(got.shape)} / "
             f"{tuple(want.shape)}, relative L2 error {err:.3g} > {GRAD_REL}")
    return err


def train_phase(seed: int, dev: torch.device, rng: np.random.Generator) -> list[dict]:
    """Phase 5: the vocoder GAN train step at production width. Returns the
    kernels line's entries of the training kernels."""
    hp = load_config(os.path.join(ROOT, "egs", "soak_r5", "vocoder.yaml"))
    shipped = hp["train_precision"]
    hp.update(train_precision="highest", max_updates=TRAIN_STEPS, tb_log_interval=1, seed=seed)
    task = VocoderTask(hp)
    # the batch, as VocoderDataset.collate cuts it: max_samples // hop = 25 mel
    # frames and their 25 · 320 = 8000 samples, the mels from the serving K1
    n_frames = hp["max_samples"] // hp["hop_size"]
    wavs = torch.from_numpy(np.stack([synth_wav(rng, n_frames * hp["hop_size"] / SR)
                                      for _ in range(TRAIN_B)])).to(dev)
    mels = logmel(wavs, MelConfig.from_hparams(hp))[:, :n_frames].contiguous()
    batch = {"mels": mels, "wavs": wavs}
    T = wavs.shape[1]
    mlp = hp["mel_loss_param"]
    gan_cfgs = gan_mel_configs(hp["audio_sample_rate"], mlp["mel_bin"], mlp["fft_sizes"],
                               mlp["hop_sizes"], mlp["win_lengths"])

    # the training kernels against their plain versions at the step's shapes
    gen = torch.Generator().manual_seed(seed)
    geoms = msd_grouped_geometries(T)
    k2_err = k2_grad_err = 0.0
    for scale, t, ci, co, k, s, g, pd in geoms:
        x = torch.randn(TRAIN_B, t, ci, generator=gen).to(dev)
        w = ((torch.rand(co, ci // g, k, generator=gen) * 2 - 1) * (3 / (k * ci // g)) ** 0.5
             ).to(dev)
        got, got_grads = value_and_grads(
            lambda xx, ww: groupconv(xx, ww, stride=s, padding=(pd, pd), groups=g), x, w)
        want, want_grads = value_and_grads(
            lambda xx, ww: grouped_conv1d_reference(xx, ww, stride=s, padding=(pd, pd),
                                                    groups=g), x, w)
        name = f"groupconv scale {scale} {ci}->{co} s{s} g{g} T{t}"
        k2_err = max(k2_err, compare(name, got, want, LOGMEL_ATOL, LOGMEL_RTOL))
        for which, a, b in zip(("dx", "dw"), got_grads, want_grads):
            k2_grad_err = max(k2_grad_err, compare_grad(f"{name} {which}", a, b))
    k1_err = k1_grad_err = 0.0
    k1_notes = []
    for cfg in gan_cfgs:
        got, (got_grad,) = value_and_grads(lambda w: logmel_gan(w, cfg), wavs)
        want, (want_grad,) = value_and_grads(lambda w: logmel_gan_reference(w, cfg), wavs)
        name = f"logmel_gan n_fft {cfg.n_fft}"
        err, note = compare_logmel(name, got, want,
                                   lambda: logmel_gan_reference(wavs.double(), cfg))
        k1_err = max(k1_err, err)
        k1_notes += [note] if note else []
        grad_err = rel_l2(got_grad, want_grad)
        k1_grad_err = max(k1_grad_err, grad_err)
        if grad_err > GRAD_REL:
            exact = logmel_gan_route_grad(wavs, cfg, logmel_gan_exact(wavs, cfg))
            exact_err = rel_l2(got_grad, exact)
            k1_notes.append(f"{name} dwav: relative L2 {grad_err:.3g} from the fp32 plain "
                            f"version, {exact_err:.3g} from the exact function (the fp32 plain "
                            f"version {rel_l2(want_grad, exact):.3g} from it)")
            if exact_err > GRAD_REL:
                fail(f"{k1_notes[-1]} (limit {GRAD_REL})")
    torch.cuda.synchronize()
    print(f"train kernels: groupconv (K2) on the MSD's {len(geoms)} grouped geometries at "
          f"B={TRAIN_B}, T={T}: max abs {k2_err:.3g} (atol {LOGMEL_ATOL}, rtol {LOGMEL_RTOL}), "
          f"dx/dw through its autograd Function max relative L2 {k2_grad_err:.3g} (limit "
          f"{GRAD_REL}); logmel_gan (K1's GAN form) at n_fft {[c.n_fft for c in gan_cfgs]}, "
          f"{mlp['mel_bin']} mels: max abs {k1_err:.3g}, dwav (analytic backward) relative L2 "
          f"{k1_grad_err:.3g}" + (f"; held to float64: {'; '.join(k1_notes)}" if k1_notes
                                  else ""), flush=True)

    # the step at production width: Trainer.fit, CUDA events between batches
    events: list = []

    def batches():
        for _ in range(TRAIN_STEPS):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            yield batch
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    work_dir = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(work_dir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logmel_gan.launches = groupconv.launches = 0
    state = Trainer(task, hp, work_dir).fit(batches())
    k1_launches, k2_launches = logmel_gan.launches, groupconv.launches
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if int(state["step"]) != TRAIN_STEPS or len(records) != TRAIN_STEPS:
        fail(f"Trainer.fit ran {int(state['step'])} steps, logged {len(records)}")
    if not all(np.isfinite(v) for r in records for v in r.values() if isinstance(v, float)):
        fail(f"non-finite training metrics: {records}")
    skipped = sum(r["skipped"] for r in records)
    if skipped:
        fail(f"{skipped:.0f} of {TRAIN_STEPS} updates skipped (non-finite gradients)")
    if not os.path.exists(os.path.join(work_dir, f"model_ckpt_steps_{TRAIN_STEPS}.ckpt")):
        fail("Trainer.fit wrote no checkpoint")
    # what the code's own structure predicts per step: the mel loss's
    # resolutions on y and y_hat; the MSD's grouped layers on y_hat in the
    # generator step and on y and y_hat in the discriminator step
    k1_pred = 2 * len(gan_cfgs)
    k2_pred = 3 * len(geoms)
    if k1_launches != k1_pred * TRAIN_STEPS or k2_launches != k2_pred * TRAIN_STEPS:
        fail(f"kernel launches per step: logmel_gan {k1_launches / TRAIN_STEPS}, groupconv "
             f"{k2_launches / TRAIN_STEPS}; predicted {k1_pred}, {k2_pred}")
    losses = ", ".join(f"{k} {v:.5g}" for k, v in records[-1].items()
                       if k not in ("step", "prefix", "skipped", "steps_per_s"))
    print(f"train: VocoderTask + Trainer.fit, egs/soak_r5/vocoder.yaml at full width "
          f"(512-channel generator, MPD + MSD, 320-bin mel loss, MR-STFT loss), "
          f"train_precision highest set over the shipped {shipped!r} (fp32, TF32 off), "
          f"random weights seed {seed}, B={TRAIN_B} x {T} samples ({n_frames} mel frames), "
          f"{TRAIN_STEPS} steps: skipped {skipped:.0f}; ms per step (CUDA events) "
          f"{[round(x, 3) for x in step_ms]}, median after 1 warmup step "
          f"{np.median(step_ms[1:]):.3f}; peak memory {peak_gb:.3f} GB; launches per step "
          f"logmel_gan {k1_launches / TRAIN_STEPS:g} (predicted {k1_pred}), groupconv "
          f"{k2_launches / TRAIN_STEPS:g} (predicted {k2_pred}); step {TRAIN_STEPS} losses: "
          f"{losses}", flush=True)

    # where one step's time goes: torch.profiler over one more step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ours = {name: [e for e in kernels if key in e.key]
            for name, key in (("groupconv", "groupconv_tf32x3_kernel"),
                              ("logmel_gan", "logmel_fft_kernel"))}
    count = {name: sum(e.count for e in evs) for name, evs in ours.items()}
    ms = {name: sum(e.self_device_time_total for e in evs) / 1e3 for name, evs in ours.items()}
    stale = [e.key for e in kernels if "dft_mag_kernel" in e.key or "mel_log_kernel" in e.key]
    if count != {"groupconv": k2_pred, "logmel_gan": k1_pred} or stale:
        fail(f"profiled step: kernels {count}, predicted groupconv {k2_pred} and logmel_gan "
             f"{k1_pred}; two-launch K1 kernels {stale}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"train profile: one step under torch.profiler: wall {wall_ms:.3f} ms, device "
          f"kernels {device_ms:.3f} ms (busy {100 * device_ms / wall_ms:.1f}%), "
          f"{sum(e.count for e in kernels)} kernels; K2 groupconv_tf32x3_kernel "
          f"x{count['groupconv']} {ms['groupconv']:.3f} ms, K1 logmel_fft_kernel "
          f"x{count['logmel_gan']} {ms['logmel_gan']:.3f} ms; largest: "
          + "; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in top), flush=True)

    # the card's step against the CPU's, from the same state and batch
    state0 = task.init_state(torch.Generator().manual_seed(seed + 1))
    small = {k: v[:CHECK_B] for k, v in batch.items()}
    t0 = time.perf_counter()
    new_gpu, m_gpu = task.train_step(state0, small)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    task_cpu = VocoderTask(hp, device="cpu")
    t0 = time.perf_counter()
    with torch.backends.mkldnn.flags(enabled=False):
        new_cpu, m_cpu = task_cpu.train_step(tree_map(lambda t: t.cpu(), state0),
                                             {k: v.cpu() for k, v in small.items()})
    t_cpu = time.perf_counter() - t0
    loss_err = max(abs(float(m_gpu[k]) - float(m_cpu[k])) / max(abs(float(m_cpu[k])), 1e-30)
                   for k in m_cpu if k != "skipped")
    if loss_err > STEP_RTOL or float(m_gpu["skipped"]) or float(m_cpu["skipped"]):
        fail(f"card step losses {m_gpu} != CPU step losses {m_cpu} (rtol {STEP_RTOL})")
    # the optimizer's first moment after a first step is (1 - b1) · the clipped
    # gradient, leaf by leaf
    mu = {name: {opt: tree_leaves(st[opt]["mu"]) for opt in ("opt_g", "opt_d")}
          for name, st in (("card", new_gpu), ("cpu", new_cpu))}
    errs = {opt: [rel_l2(a.cpu(), b) for a, b in zip(mu["card"][opt], mu["cpu"][opt])]
            for opt in ("opt_g", "opt_d")}
    worst = {opt: max(range(len(e)), key=e.__getitem__) for opt, e in errs.items()}
    past = [(opt, i) for opt in errs for i, e in enumerate(errs[opt]) if e > STEP_GRAD_REL]
    f64_note = ""
    if past:
        with torch.backends.mkldnn.flags(enabled=False):
            new_64, _ = task_cpu.train_step(
                tree_map(lambda t: t.cpu().double() if t.is_floating_point() else t.cpu(),
                         state0), {k: v.cpu().double() for k, v in small.items()})
        notes = []
        for opt, i in past:
            e_64 = rel_l2(mu["card"][opt][i].cpu(), tree_leaves(new_64[opt]["mu"])[i])
            notes.append(f"{opt} leaf {i} {tuple(mu['cpu'][opt][i].shape)}: vs CPU fp32 "
                         f"{errs[opt][i]:.3g}, vs CPU float64 {e_64:.3g}")
            if e_64 > STEP_GRAD_REL:
                fail(f"card gradient leaf off the CPU's float64 step: {notes[-1]} "
                     f"(limit {STEP_GRAD_REL})")
        f64_note = "; held to the float64 CPU step instead: " + "; ".join(notes)
    print(f"train check: one step at B={CHECK_B} on the card ({t_gpu:.2f} s) against the same "
          f"step on the CPU with device='cpu' ({t_cpu:.2f} s, plain versions, oneDNN off): "
          f"loss terms max rel diff {loss_err:.3g} (rtol {STEP_RTOL}); gradient leaves max "
          f"rel L2 G {max(errs['opt_g']):.3g}, D {max(errs['opt_d']):.3g} over "
          f"{len(errs['opt_g'])} + {len(errs['opt_d'])} leaves (limit {STEP_GRAD_REL}; "
          f"worst G leaf {worst['opt_g']}, D leaf {worst['opt_d']}){f64_note}", flush=True)

    # the kernels' times at the step's shapes
    k2_rows = groupconv_times(geoms, gen, dev)
    k2_sum = {key: sum(r[key] for r in k2_rows)
              for key in ("ms", "kernel_device_ms", "plain_ms", "library_ms", "bound_ms",
                          "bwd_dx_dw_ms", "bwd_dx_ms")}
    k2_by = {by: sum(r["bound_ms"] for r in k2_rows if r["bound_by"] == by)
             for by in ("bytes", "operations")}
    print(f"train groupconv sums over the {len(geoms)} geometries: kernel {k2_sum['ms']:.4f} "
          f"ms (device {k2_sum['kernel_device_ms']:.4f} ms), cuDNN {k2_sum['library_ms']:.4f} "
          f"ms, plain {k2_sum['plain_ms']:.4f} ms, bound "
          f"{k2_sum['bound_ms']:.4g} ms; backward dx+dw {k2_sum['bwd_dx_dw_ms']:.4f} ms, dx "
          f"{k2_sum['bwd_dx_ms']:.4f} ms, so per step (2 MSD passes with dx+dw in the "
          f"discriminator step, 1 with dx in the generator step) forward "
          f"{3 * k2_sum['ms']:.4f} ms, backward "
          f"{2 * k2_sum['bwd_dx_dw_ms'] + k2_sum['bwd_dx_ms']:.4f} ms", flush=True)
    with torch.no_grad():
        k1_ms = k1_device_ms = k1_plain_ms = k1_library_ms = k1_bound_ms = 0.0
        k1_bound = {"bytes": 0.0, "operations": 0.0}
        for cfg in gan_cfgs:
            window = torch.hann_window(cfg.win_length, periodic=True, device=dev)
            melw = logmel_gan.dense_constants(cfg, dev)[1]
            k1_ms += cuda_ms(lambda: logmel_gan(wavs, cfg))
            k1_device_ms += kernel_device_ms(lambda: logmel_gan(wavs, cfg), "logmel_fft_kernel")
            k1_plain_ms += cuda_ms(lambda: logmel_gan_reference(wavs, cfg))
            k1_library_ms += cuda_ms(lambda: library_logmel_gan(wavs, cfg, window, melw))
            b_ms, b_by = logmel_bound_ms(TRAIN_B, T, T // cfg.hop, cfg, melw)
            k1_bound_ms += b_ms
            k1_bound[b_by] += b_ms
    print(f"train kernel times: logmel_gan over its {len(gan_cfgs)} resolutions on "
          f"B={TRAIN_B} x {T}: kernel {k1_ms:.4f} ms (device {k1_device_ms:.4f} ms), plain "
          f"{k1_plain_ms:.4f} ms, torch.stft "
          f"chain {k1_library_ms:.4f} ms, bound {k1_bound_ms:.4g} ms", flush=True)
    scale1 = {key: k2_rows[0][key]
              for key in ("ms", "kernel_device_ms", "plain_ms", "library_ms", "bound_ms")}
    return [
        {"name": "logmel_gan", "route": "cuda", "source": "conan_tpu_torch/csrc/logmel.cu",
         "replaces": "conan_tpu/ops/pallas_stft.py:151", "launches": k1_launches,
         "max_abs_err": k1_err, "max_abs_diff": k1_err, "ms": k1_ms,
         "kernel_device_ms": k1_device_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound_ms, "bound_by": max(k1_bound, key=k1_bound.get),
         "library_ms": k1_library_ms},
        {"name": "groupconv", "route": "cuda", "source": "conan_tpu_torch/csrc/groupconv.cu",
         "replaces": "conan_tpu/ops/pallas_groupconv.py:56", "launches": k2_launches,
         "max_abs_err": k2_err, "max_abs_diff": k2_err, "ms": k2_sum["ms"],
         "kernel_device_ms": k2_sum["kernel_device_ms"],
         "plain_ms": k2_sum["plain_ms"], "bound_ms": k2_sum["bound_ms"],
         "bound_by": max(k2_by, key=k2_by.get), "library_ms": k2_sum["library_ms"],
         "bound_route": k2_rows[0]["route"], "geometries": len(geoms),
         "scale1_layer": scale1},
    ]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trained", default="",
                    help="comma list of stages (conan, emf, voc) that load the trained "
                         "checkpoints/soak_r5_<stage>/deploy weights; the rest are random")
    args = ap.parse_args()
    trained = [name for name in args.trained.split(",") if name]
    if not set(trained) <= set(STAGES):
        ap.error(f"--trained takes stages of {STAGES}, got {args.trained!r}")

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    log = native.build(force=True)
    native.load()
    ptxas = [line.split("ptxas info    : ")[-1] for line in log.splitlines()
             if "registers" in line or "spill" in line]
    spills = [line for line in ptxas
              if any(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))]
    print(f"build: {', '.join(src.name for src in native.SOURCES)} by one nvcc in "
          f"{time.perf_counter() - t0:.2f} s [{'; '.join(ptxas)}]", flush=True)
    if spills:
        fail(f"ptxas reports register spills: {spills}")

    # 3. kernels against their plain versions, at the main path's shapes
    mel_cfg = MelConfig()
    rng = np.random.default_rng(args.seed)
    if trained:
        wav_dir = os.path.join(ROOT, "checkpoints", "soak_r5_conan", "valid_wavs")
        src, ref = read_wav(f"{wav_dir}/gt_b0.wav"), read_wav(f"{wav_dir}/gt_b1.wav")
    else:
        src, ref = synth_wav(rng, 5.12), synth_wav(rng, 2.56)
    window = torch.hann_window(mel_cfg.win_length, periodic=True, device=dev)
    melw = logmel.dense_constants(mel_cfg, dev)[1]
    batch8 = torch.randn(8, 3 * SR + 123, generator=torch.Generator().manual_seed(args.seed))
    err, shapes, notes = 0.0, [], []
    for wav in (torch.from_numpy(src[None]), torch.from_numpy(ref[None]), 0.2 * batch8):
        wav = wav.to(dev).contiguous()
        shapes.append(tuple(wav.shape))
        got, want = logmel(wav, mel_cfg), logmel_reference(wav, mel_cfg)
        torch.cuda.synchronize()
        e, note = compare_logmel(f"logmel at {shapes[-1]}", got, want,
                                 lambda: logmel_reference(wav.double(), mel_cfg))
        err = max(err, e)
        notes += [note] if note else []
    wav = torch.from_numpy(src[None]).to(dev).contiguous()
    # one launch, and nothing allocated but the output (no magnitude scratch)
    torch.cuda.synchronize()
    base, launches0 = torch.cuda.memory_allocated(), logmel.launches
    torch.cuda.reset_peak_memory_stats()
    out = logmel(wav, mel_cfg)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    if logmel.launches != launches0 + 1 or extra > -(-out.numel() * 4 // 512) * 512:
        fail(f"logmel call: {logmel.launches - launches0} launches, {extra} bytes allocated "
             f"for a {out.numel() * 4}-byte output")
    ms = cuda_ms(lambda: logmel(wav, mel_cfg))
    serve_device_ms = kernel_device_ms(lambda: logmel(wav, mel_cfg), "logmel_fft_kernel")
    plain_ms = cuda_ms(lambda: logmel_reference(wav, mel_cfg))
    library_ms = cuda_ms(lambda: library_logmel(wav, mel_cfg, window, melw))
    lib_err = float((library_logmel(wav, mel_cfg, window, melw)
                     - logmel_reference(wav, mel_cfg)).abs().max())
    bound_ms, bound_by = logmel_bound_ms(1, wav.shape[1], wav.shape[1] // mel_cfg.hop + 1,
                                         mel_cfg, melw)
    print(f"kernels: logmel max_abs_err {err:.3g} (atol {LOGMEL_ATOL}, rtol {LOGMEL_RTOL}) "
          f"over {shapes}; at B=1 T={wav.shape[1]}: kernel {ms:.4f} ms (device "
          f"{serve_device_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"torch.stft chain {library_ms:.4f} ms (max abs vs plain {lib_err:.3g}), "
          f"bound {bound_ms:.4g} ms by {bound_by}"
          + (f"; held to float64: {'; '.join(notes)}" if notes else ""), flush=True)

    # 4. the main path: build_engine(...).infer_once, then infer_offline
    hparams = {name: load_config(os.path.join(ROOT, "egs", "soak_r5", f"{name}.yaml"))
               for name in ("conan", "emformer", "vocoder")}
    dirs = write_random_checkpoints(os.path.join(ROOT, "build", "chip_smoke_ckpt"),
                                    hparams, seed=args.seed)
    dirs = [os.path.join(ROOT, "checkpoints", f"soak_r5_{name}", "deploy")
            if name in trained else d for name, d in zip(STAGES, dirs)]
    eng = build_engine(*dirs, serving_precision="exact")
    torch.cuda.reset_peak_memory_stats()
    logmel.launches = 0
    wav_s, codes_s = eng.infer_once(src, ref, collect_codes=True)
    launches_once = logmel.launches
    wav_o, codes_o = eng.infer_offline(src, ref, collect_codes=True)
    launches = logmel.launches
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_frames = len(src) // mel_cfg.hop + 1
    if wav_s.shape != (1, n_frames * mel_cfg.hop) or wav_o.shape != wav_s.shape:
        fail(f"waveform shapes {wav_s.shape} / {wav_o.shape}")
    if not (np.isfinite(wav_s).all() and np.isfinite(wav_o).all()):
        fail("non-finite waveform")
    stream_err = float(np.abs(wav_s - wav_o).max())
    if stream_err > STREAM_ATOL:
        fail(f"streaming != offline: max abs {stream_err:.3g} > {STREAM_ATOL}")
    if not np.array_equal(codes_s, codes_o):
        fail(f"streaming codes differ from offline at {int((codes_s != codes_o).sum())} frames")
    if launches_once != 2:
        fail(f"infer_once launched the logmel kernel {launches_once} times, not 2 (src, ref)")

    # timing: a warm infer_once for the RTF, then the chunk loop with events
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.infer_once(src, ref)
    torch.cuda.synchronize()
    rtf = (time.perf_counter() - t0) / (len(src) / SR)
    chunk_ms = []
    with torch.inference_mode():
        src_mel = eng.wav_to_mel(src)
        style = eng._prepare(eng.wav_to_mel(ref))
        mel_ext, _T, T_pad = eng._source_chunks(src_mel)
        seg, rc = eng.cfg.seg, eng.cfg.rc
        for _pass in range(2):        # the first pass warms up
            state = eng.init_state(1)
            events = []
            for s in range(0, T_pad, seg):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                _w, _c, state = eng._chunk_step(state, mel_ext[:, s:s + seg + rc], style)
                b.record()
                events.append((a, b))
            torch.cuda.synchronize()
            chunk_ms = [a.elapsed_time(b) for a, b in events]
    weights = ", ".join(f"{name} {'trained' if name in trained else f'random seed {args.seed}'}"
                        for name in STAGES)
    print(f"main: r5 geometry ({weights}), exact, B=1, {len(src) / SR:.2f} s src / "
          f"{len(ref) / SR:.2f} s ref: {len(chunk_ms)} chunks, streaming vs offline max abs "
          f"{stream_err:.3g} (atol {STREAM_ATOL}), codes equal; logmel launches "
          f"{launches_once} per infer_once, {launches} on the main path; chunk step median "
          f"{np.median(chunk_ms):.3f} ms p90 {np.percentile(chunk_ms, 90):.3f} ms "
          f"(CUDA events); RTF {rtf:.4f}; peak memory {peak_gb:.3f} GB", flush=True)

    # where the chunk step's time goes: torch.profiler over 16 warm chunk steps
    n_prof = 16
    with torch.inference_mode():
        state = eng.init_state(1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for s in range(0, n_prof * seg, seg):
                _w, _c, state = eng._chunk_step(state, mel_ext[:, s:s + seg + rc], style)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / n_prof
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("stage:")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n_prof
    stages = ", ".join(f"{e.key[6:]} host {e.cpu_time_total / 1e3 / n_prof:.3f} / device "
                       f"{e.device_time_total / 1e3 / n_prof:.3f}"
                       for e in events if e.key.startswith("stage:")
                       and e.device_type == DeviceType.CPU)
    print(f"profile: {n_prof} chunk steps under torch.profiler: wall {wall_ms:.3f} ms/chunk, "
          f"device kernels {device_ms:.3f} ms/chunk (busy {100 * device_ms / wall_ms:.1f}%), "
          f"{sum(e.count for e in kernels) / n_prof:.0f} kernels/chunk; ms/chunk by stage: "
          f"{stages}", flush=True)

    kernel = {"name": "logmel", "route": "cuda", "source": "conan_tpu_torch/csrc/logmel.cu",
              "replaces": "conan_tpu/ops/pallas_stft.py:52", "launches": launches,
              "max_abs_err": err, "max_abs_diff": err, "ms": ms,
              "kernel_device_ms": serve_device_ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}

    # 5. train
    train_kernels = train_phase(args.seed, dev, rng)

    # 6. kernels line, 7. result line
    print(json.dumps({"kernels": [kernel, *train_kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
