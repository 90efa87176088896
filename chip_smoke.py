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
  4b. scan    the same engine through stream_scan, the chunk step captured
              once into a CUDA graph and replayed per chunk:
              infer_once(use_scan=True, bucket_lengths=True) against the
              eager loop (codes equal, 1e-5) and offline (1e-4); replay ms
              per chunk, RTF, kernels per chunk and busy share, memory, the
              cost of one more capture (a reference of another length: the
              reference is never padded); then the "high" and "fast" rungs
              captured against their eager loops and against exact (SNR dB,
              max abs, code flips)
  4c. flow    egs/conan_emformer_flow.yaml (the rectified-flow F0 head: a
              10x192 DiffNet, K = 100 Euler steps a chunk) with the r5
              Emformer and vocoder: eager loop, captured loop and offline
              agree (codes equal, wav 1e-4, F0 1e-3); chunk ms eager and
              captured, launches per chunk
  4d. run_vc  the batch runner's main (the CLI's argv) on two synthesized
              pairs with a denoise constant set: exit 0, each written wav
              equals the engine's use_scan output after postprocess; one
              denoise call on the card against the CPU's
  5. train    the vocoder GAN train step at production width
              (egs/soak_r5/vocoder.yaml with train_precision: highest set
              over it, i.e. fp32 "exact"): the training kernels (K2 on the
              MSD's 15 grouped geometries, K1's GAN form at its three n_fft)
              against their plain versions in value and gradient; then
              VocoderTask + Trainer.fit for 5 steps at B = 18: loss terms,
              skipped updates, ms per step, peak memory, kernel launches per
              step against the count the code predicts, and a profiled step;
              then the same batch through Trainer.fit at the shipped rung
              (train_precision default: bf16 operands, K2-bf16 on the MSD,
              its launches counted); then one step at B = 2 on the card
              against the same step on the CPU in fp32 (losses) and float64
              (gradients), and the "default" and "high" steps against the
              float64 one; then K2 on each grouped geometry beside cuDNN,
              its bound and cuDNN's backward there, K2-bf16 on each against
              its plain version (values, dx, dw) beside cuDNN in bf16, and
              K1's GAN form's times
  6. conan_train  the Conan acoustic GAN at production width
              (egs/soak_r5/conan.yaml, train_precision highest set over the
              shipped default): 24
              synthesized utterances of 1400-1496 frames binarized by
              ConanBinarizer (K1 once an utterance; each stored mel held
              to the plain version on its wav) and batched by
              build_train_iter (B = 24 at the 1496 rung), Trainer.fit for 8
              steps with the schedule gates scaled down to cross every phase
              (k-means hook, VQ, forcing off, discriminator, random
              references): ms per step, hook time, peak memory, a profiled
              step; the last batch at the shipped rung (default); then one
              small-width step on the card against the CPU's, and at the
              "default" and "high" rungs against its float64 step
  7. emformer_train  the Emformer distillation at production width
              (egs/soak_r5/emformer.yaml, train_precision highest) through
              the port's CLIs: 36 synthesized utterances of 480-500 frames
              (4 of them the valid split) binarized by run_binarize.main
              (K1 once an utterance, each stored mel held to the plain
              version), train.run.main for 20 steps (B = 16 x 530 input
              frames; validation and a checkpoint every 10), again to 30
              (resumed at 20), --validate; the engine built from the
              trained work dir (streaming against offline); the step timed
              at B = 16 x 528 frames (ms, peak memory, a profiled step) and
              at the longest rung, B = 2 x 3000 (its mask's build time),
              and at the shipped rung (default); then one small-width step
              on the card against the CPU's, and at both rungs
  8. postnet_train  the mel postnet as shipped (egs/soak_r5/postnet.yaml:
              a 20x256 DiffNet, train_precision default, no override) on
              conan_train's corpus and trained work dir: spec_stats, the
              training CLI for 4 steps and resumed to 6, a step timed on
              its first batch; then one small-width step on the card
              against the CPU's, and at both rungs
  9. {"kernels": [...]}
  10. {"ok": true, "device": {...}}

The weights are random, made from --seed and written as checkpoint dirs
under build/; the audio is synthesized from the seed. --trained names the
stages (conan, emf, voc) that load the trained checkpoints/soak_r5_<stage>/
deploy weights instead; the audio then is two of the r5 validation wavs, and
the run stops after phase 4b (serving, the rungs against exact), its kernels
line holding logmel alone. Imports nothing of JAX or conan_tpu.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from conan_tpu_torch.config import load_config, set_hparams
from conan_tpu_torch.data.binarizer import ConanBinarizer, load_wav
from conan_tpu_torch.data.record_store import RecordReader
from conan_tpu_torch.infer import run_vc
from conan_tpu_torch.infer.build import build_engine, write_random_checkpoints
from conan_tpu_torch.models.vocoder.discriminators import DiscriminatorS
from conan_tpu_torch.ops import native
from conan_tpu_torch.ops.groupconv import (groupconv, grouped_conv1d_bf16_reference,
                                           grouped_conv1d_reference)
from conan_tpu_torch.ops.precision import precision_scope, rounded_dot, training_scope
from conan_tpu_torch.ops.logmel import (GAN_CLIP, GAN_EPS, _gan_vjp, gan_pad, logmel,
                                        logmel_gan, logmel_gan_reference, logmel_reference)
from conan_tpu_torch.train.losses import gan_mel_configs
from conan_tpu_torch.train.run import build_task, build_train_iter, use_random_ref_after
from conan_tpu_torch.train.tasks import ConanTask, VocoderTask
from conan_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 16000
STAGES = ("conan", "emf", "voc")  # build_engine's order
# Published H100 SXM peaks (dense): fp32 outside the tensor cores, TF32 on
# them, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
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
# the captured loop against the eager loop in exact: the same kernels on the
# same inputs
CAPTURED_ATOL = 1e-5
# F0 in Hz, streaming against offline (tests/test_streaming_engine.py:117)
F0_ATOL, F0_RTOL = 1e-3, 1e-4
# the denoise on the card against the CPU: fp32 framed DFT products in other
# orders (tests/test_torch_run_vc.py holds the port to JAX's at 1e-5)
DENOISE_ATOL = 1e-5
DENOISE_C = 0.01
# the flow phase times this many eager chunk steps one by one (after one warm
# step); its whole eager call, all chunks, is timed as well
FLOW_EAGER_CHUNKS = 6
# The training kernels against their plain versions: values as K1 above (fp32
# sums in another order); gradients (dx and dw of K2 through its autograd
# Function, dwav of K1's analytic backward) a relative L2 error of 1e-4 per
# tensor. An absolute bound does not scale with the step's shapes: K2's dw at
# scale 1 sums 18 · 4000 products, and both sides start from outputs that
# differ in their fp32 rounding.
GRAD_REL = 1e-4
# The card's train step (kernels K1 and K2, cuDNN) against the CPU's (plain
# versions, oneDNN off) from the same state and batch: loss terms rtol 1e-4.
# Gradient leaves are held to the same step run in float64 on the CPU: each
# leaf's relative L2 error within 1e-3, or within 4x the CPU fp32 step's worst
# leaf where that is larger. At random init the mel loss's gradient is
# ill-conditioned enough that any fp32 step leaves some leaves past 1e-3 on
# many batches: over seeds 0-5 and one more batch, the CPU's fp32 step went
# past it on 3 of 7 (up to 2.05e-3), oneDNN's on 3, the card's on 4 (up to
# 2.85e-3, and at most 2.01x the CPU's worst leaf on the same batch), and
# rounding only the generator's output to fp32 in a float64 step moved a
# leaf 1.38e-3 (tools/torch_kernel_lab.py step; the card's float64 step is
# 1.4e-7 from the CPU's). A wrong gradient is off by far more.
STEP_RTOL, STEP_GRAD_REL, STEP_FP32_FACTOR = 1e-4, 1e-3, 4
TRAIN_B, TRAIN_STEPS, CHECK_B = 18, 5, 2
# The conan_train phase: a corpus of 4 speakers x 6 synthesized utterances of
# 1400-1496 frames, binarized and batched by the port at max_tokens 36000
# (B = 24 at the ladder's 1496 rung), then CONAN_STEPS steps with the
# schedule gates scaled down so that they cross every phase: the k-means
# hook before step 2 and VQ on from it, forcing off from step 2, the
# discriminator on from step 3, random references from step 5.
CONAN_SPEAKERS, CONAN_UTTS, CONAN_FRAMES = 4, 6, (1400, 1496)
CONAN_STEPS = 8
CONAN_GATES = {"vq_start": 1, "forcing": 2, "disc_start_steps": 3, "random_speaker_steps": 5}
# its card-vs-CPU check: tests/test_train_steps.py's small width, two of the
# corpus's utterances cut to 160 frames (references to 128), at a step where
# every gate is on (VQ, guided attention, discriminator, random reference)
CONAN_CHECK_HP = {"hidden_size": 32, "nVQ": 16, "mel_disc_hidden_size": 8}
CONAN_CHECK_FRAMES, CONAN_CHECK_REF, CONAN_CHECK_STEP = 160, 128, 4
# The emformer_train phase: 4 training speakers x 8 synthesized utterances of
# 480-500 frames and 4 of a valid speaker, binarized and trained through the
# port's CLIs on egs/soak_r5/emformer.yaml: max_tokens 8000 and max_sentences
# 16 pack B = 16 at the ladder's 528 rung (530 input frames with the
# lookahead). EMF_STEPS steps with a validation and a checkpoint every
# EMF_VAL_EVERY, then a resumed run to EMF_RESUMED; the step timed at that
# shape (EMF_WARM warm, EMF_TIMED by CUDA events) and at the longest rung,
# B x T = EMF_LONG (max_frames; 8000 tokens cap B at 2).
EMF_SPEAKERS, EMF_UTTS, EMF_VALID_UTTS, EMF_FRAMES = 4, 8, 4, (480, 500)
EMF_STEPS, EMF_RESUMED, EMF_VAL_EVERY = 20, 30, 10
EMF_WARM, EMF_TIMED, EMF_LONG = 3, 10, (2, 3000)
# its card-vs-CPU check: 2 layers of FFN 64 over the corpus's mels, two
# utterances cut to 32 segments
EMF_CHECK = {"num_layers": 2, "ffn_dim": 64}
EMF_CHECK_FRAMES = 128
# K2-bf16 against its plain version (the fp32 grouped conv of the rounded
# operands): values as K2's (fp32 sums in another order); dx and dw, which
# cuDNN computes from bf16 operands and returns in bf16, against the same
# convs in fp32 on the rounded operands with the incoming gradient rounded
# (precision.rounded_dot): one bf16 rounding of each result, at most 2^-9
# of an element, about 2^-9 / sqrt(3) = 1.1e-3 in relative L2.
BF16_GRAD_REL = 4e-3
# The shipped training rung ("default": bf16 operands) and TF32 ("high")
# rows of each training phase: RUNG_STEPS steps on the phase's own batch
# after one warm step. Each phase's small-width check also runs its step at
# both rungs on the card from the same state and batch and holds it to the
# CPU's float64 step: the losses' sum, and the gradient leaves as one tree
# (the first moments), in relative terms within RUNG_BOUND. The bounds are
# 3-4x the worst of the first card runs of these checks and of the card
# tests' (tests/test_torch_cuda.py, another width; PERF.md §6). The
# vocoder's is loose because its gradient at random init is
# ill-conditioned: the mel loss's 1/mel factors amplify any rounding, and
# exact DEFAULT arithmetic on the CPU (bf16-rounded operands, fp32 sums)
# already moves its gradient tree by 0.34 where fp32 moves it by 2.3e-5.
RUNG_STEPS = 3
RUNG_BOUND = {
    "vocoder": {"default": {"loss": 0.03, "tree": 0.7}, "high": {"loss": 1e-4, "tree": 0.05}},
    "conan": {"default": {"loss": 0.05, "tree": 0.06}, "high": {"loss": 6e-4, "tree": 0.01}},
    "emformer": {"default": {"loss": 3e-4, "tree": 0.1}, "high": {"loss": 5e-5, "tree": 0.02}},
    "postnet": {"default": {"loss": 1e-5, "tree": 0.02}, "high": {"loss": 1e-5, "tree": 3e-3}},
}
# The postnet_train phase: egs/soak_r5/postnet.yaml as shipped (a 20x256
# DiffNet over the mel, train_precision default) on conan_train's corpus
# and trained work dir, after spec_stats: POST_STEPS steps through the
# training CLI, resumed to POST_RESUMED; its check at the width below.
POST_STEPS, POST_RESUMED = 4, 6
POST_CHECK = {"residual_layers": 2, "residual_channels": 16}


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
    host), this is the kernel alone. A profiler window that recorded fewer
    than half the launches (once, one recorded none of a K2 geometry's 20)
    is taken again, twice at most, with a note; then it fails."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and key in e.key]
        count = sum(e.count for e in evs)
        if iters // 2 <= count <= iters:
            return sum(e.self_device_time_total for e in evs) / 1e3 / count
        print(f"kernel_device_ms: profiler window {attempt + 1} saw {count} launches of {key} "
              f"in {iters} calls", flush=True)
    fail(f"profiler saw {count} launches of {key} in {iters} calls, three windows running")


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


def synth_wav(rng: np.random.Generator, seconds: float, with_f0: bool = False):
    """A voiced-like test signal: harmonics of a gliding 100-220 Hz f0 with
    a syllable envelope, plus noise. With ``with_f0``, (wav, f0 per sample
    in Hz)."""
    t = np.arange(int(seconds * SR)) / SR
    f0 = 160 + 60 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t + rng.uniform(0, 6))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(np.sin(k * phase) / k for k in range(1, 20))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    wav = (0.1 * env * voiced + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    return (wav, f0) if with_f0 else wav


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


def groupconv_bf16_bound_ms(B: int, T: int, ci: int, co: int, k: int, s: int, g: int,
                            pad: int) -> tuple[float, str]:
    """Least time for one grouped conv at the "default" rung, the larger of
    two: its fp32 input, weights and output once over HBM, and its true
    FLOPs (the grouped product, no zero padding of the reduction) as one
    bf16 product at the dense bf16 peak. Returns (ms, "bytes" or
    "operations")."""
    t_out = (T + 2 * pad - k) // s + 1
    flops = 2 * B * t_out * co * (ci // g) * k
    t_bytes = 4 * (B * T * ci + co * (ci // g) * k + B * t_out * co) / PEAK_HBM_BYTES
    t_ops = flops / PEAK_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def groupconv_bf16_phase(geoms: list[tuple], gen: torch.Generator, dev: torch.device
                         ) -> tuple[list[dict], float, float]:
    """K2-bf16 under the "default" rung on each grouped geometry at B =
    TRAIN_B: the value against its plain version (max abs, relative L2), dx
    and dw through its autograd Function against rounded_dot's (relative
    L2), then its time beside the plain version, cuDNN's F.conv1d on bf16
    tensors and the bound. Returns the rows, the max abs value error and the
    worst gradient relative L2."""
    rows, err, grad_err = [], 0.0, 0.0
    for scale, t, ci, co, k, s, g, pd in geoms:
        x = torch.randn(TRAIN_B, t, ci, generator=gen).to(dev)
        w = ((torch.rand(co, ci // g, k, generator=gen) * 2 - 1) * (3 / (k * ci // g)) ** 0.5
             ).to(dev)
        k2 = dict(stride=s, padding=(pd, pd), groups=g)
        name = f"groupconv_bf16 scale {scale} {ci}->{co} s{s} g{g} T{t}"
        with training_scope("default", dev):
            got, got_grads = value_and_grads(lambda xx, ww: groupconv(xx, ww, **k2), x, w)
        want, want_grads = value_and_grads(lambda xx, ww: rounded_dot(
            lambda a, b: grouped_conv1d_reference(a, b, **k2), xx, ww), x, w)
        torch.testing.assert_close(want, grouped_conv1d_bf16_reference(x, w, **k2), rtol=0,
                                   atol=0)
        err = max(err, compare(name, got, want, LOGMEL_ATOL, LOGMEL_RTOL))
        row = {"rel_l2": rel_l2(got, want)}
        for which, a, b in zip(("dx", "dw"), got_grads, want_grads):
            row[f"{which}_rel_l2"] = rel_l2(a, b)
            if row[f"{which}_rel_l2"] > BF16_GRAD_REL:
                fail(f"{name} {which}: relative L2 {row[f'{which}_rel_l2']:.3g} from the plain "
                     f"version (limit {BF16_GRAD_REL})")
            grad_err = max(grad_err, row[f"{which}_rel_l2"])
        x_cf, w_b = x.transpose(1, 2).contiguous().bfloat16(), w.bfloat16()
        with torch.no_grad(), training_scope("default", dev):
            row.update(
                ms=cuda_ms(lambda: groupconv(x, w, **k2)),
                kernel_device_ms=kernel_device_ms(lambda: groupconv(x, w, **k2),
                                                  "groupconv_bf16_kernel"),
                plain_ms=cuda_ms(lambda: grouped_conv1d_bf16_reference(x, w, **k2)),
                library_ms=cuda_ms(lambda: F.conv1d(x_cf, w_b, stride=s, padding=pd,
                                                    groups=g)))
        row["bound_ms"], row["bound_by"] = groupconv_bf16_bound_ms(TRAIN_B, t, ci, co, k, s,
                                                                   g, pd)
        rows.append(row)
        print(f"train groupconv_bf16 geometry: scale {scale} {ci}->{co} s{s} g{g} B={TRAIN_B} "
              f"T={t}: vs plain max abs {float((got - want).abs().max()):.3g}, rel L2 "
              f"{row['rel_l2']:.3g}, dx {row['dx_rel_l2']:.3g}, dw {row['dw_rel_l2']:.3g}; "
              f"kernel {row['ms']:.4f} ms (device {row['kernel_device_ms']:.4f} ms), cuDNN "
              f"bf16 F.conv1d {row['library_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4g} ms by {row['bound_by']}", flush=True)
    return rows, err, grad_err


def step_rows(task, state, batch, step_kw: dict, gen=None) -> dict:
    """RUNG_STEPS steps of ``task`` on ``batch`` from ``state`` after one
    warm step: ms per step by CUDA events and the peak memory; then one step
    under torch.profiler: wall and device ms, kernels, the largest; the last
    step's losses."""
    state, _ = task.train_step(state, batch, gen, **step_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(RUNG_STEPS + 1)]
    events[0].record()
    for i in range(RUNG_STEPS):
        state, metrics = task.train_step(state, batch, gen, **step_kw)
        events[i + 1].record()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.train_step(state, batch, gen, **step_kw)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    if float(metrics["skipped"]) or not all(np.isfinite(float(v)) for v in metrics.values()):
        fail(f"{task.precision} steps: skipped or non-finite metrics {metrics}")
    return {"ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])], "peak_gb": peak_gb,
            "wall_ms": wall_ms, "device_ms": device_ms,
            "kernels": sum(e.count for e in kernels),
            "largest": "; ".join(f"{e.key[:50]} x{e.count} "
                                 f"{e.self_device_time_total / 1e3:.3f} ms" for e in top),
            "losses": ", ".join(f"{k} {float(v):.5g}" for k, v in metrics.items()
                                if k != "skipped")}


def step_rows_text(rung: str, r: dict, beside: float | None = None) -> str:
    return (f"train_precision {rung}: ms per step (CUDA events, {RUNG_STEPS} after 1 warm) "
            f"{[round(x, 3) for x in r['ms']]}, median {np.median(r['ms']):.3f}"
            + (f" (highest's {beside:.3f})" if beside is not None else "")
            + f"; peak memory {r['peak_gb']:.3f} GB; one profiled step: wall "
            f"{r['wall_ms']:.3f} ms, device kernels {r['device_ms']:.3f} ms (busy "
            f"{100 * r['device_ms'] / r['wall_ms']:.1f}%), {r['kernels']} kernels; largest: "
            f"{r['largest']}; losses: {r['losses']}")


def rung_check(kind: str, make_task, state0: dict, batch: dict, m_64: dict, leaves_64: list,
               leaves_of, **step_kw) -> str:
    """The step at the "default" and "high" rungs on the card from
    ``state0`` and ``batch`` (no generator) against the CPU's float64 step
    (metrics ``m_64``, gradient leaves ``leaves_64``; ``leaves_of`` picks a
    state's): the relative difference of the losses' sum and the relative
    L2 of the leaves as one tree, each within RUNG_BOUND[kind] (the task's
    kind); the worst leaf is reported. Returns the text for the phase's
    check line."""
    parts = []
    total_64 = sum(float(v) for k, v in m_64.items() if k != "skipped")
    flat_64 = torch.cat([b.double().ravel() for b in leaves_64])
    for rung in ("default", "high"):
        new, m = make_task(rung).train_step(state0, batch, None, **step_kw)
        leaves = leaves_of(new)
        loss = abs(sum(float(v) for k, v in m.items() if k != "skipped") - total_64) / max(
            abs(total_64), 1e-30)
        tree = rel_l2(torch.cat([a.cpu().double().ravel() for a in leaves]), flat_64)
        worst = max(rel_l2(a.cpu(), b) for a, b in zip(leaves, leaves_64))
        bound = RUNG_BOUND[kind][rung]
        if float(m["skipped"]) or loss > bound["loss"] or tree > bound["tree"]:
            fail(f"{kind} check at {rung}: losses' sum {loss:.3g} and gradient tree {tree:.3g} "
                 f"from the CPU's float64 step (bounds {bound}), skipped {float(m['skipped'])}")
        parts.append(f"{rung} on the card vs the CPU's float64 step: losses' sum rel diff "
                     f"{loss:.3g}, gradient tree rel L2 {tree:.3g} (worst of {len(leaves)} "
                     f"leaves {worst:.3g}; bounds {bound['loss']}, {bound['tree']})")
    return "; ".join(parts)


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


def snr_db(got: np.ndarray, want: np.ndarray) -> float:
    """10 log10 of ``want``'s energy over the difference's."""
    return float(10 * np.log10(np.sum(want.astype(np.float64) ** 2)
                               / max(np.sum((got - want).astype(np.float64) ** 2), 1e-30)))


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


def train_batch(hp, rng: np.random.Generator, dev: torch.device) -> dict:
    """The train step's batch of TRAIN_B synthesized wavs, as
    VocoderDataset.collate cuts it: max_samples // hop = 25 mel frames and
    their 25 · 320 = 8000 samples, the mels from the serving K1."""
    n_frames = hp["max_samples"] // hp["hop_size"]
    wavs = torch.from_numpy(np.stack([synth_wav(rng, n_frames * hp["hop_size"] / SR)
                                      for _ in range(TRAIN_B)])).to(dev)
    mels = logmel(wavs, MelConfig.from_hparams(hp))[:, :n_frames].contiguous()
    return {"mels": mels, "wavs": wavs}


def train_phase(seed: int, dev: torch.device, rng: np.random.Generator) -> list[dict]:
    """Phase 5: the vocoder GAN train step at production width. Returns the
    kernels line's entries of the training kernels."""
    hp = load_config(os.path.join(ROOT, "egs", "soak_r5", "vocoder.yaml"))
    shipped = hp["train_precision"]
    hp_shipped = dict(hp, max_updates=RUNG_STEPS + 1, tb_log_interval=1, seed=seed)
    hp.update(train_precision="highest", max_updates=TRAIN_STEPS, tb_log_interval=1, seed=seed)
    task = VocoderTask(hp)
    batch = train_batch(hp, rng, dev)
    wavs = batch["wavs"]
    n_frames, T = batch["mels"].shape[1], wavs.shape[1]
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

    # the shipped rung, as the config is written: K2-bf16 on the MSD
    n_default = RUNG_STEPS + 1
    del events[:]

    def default_batches():
        for _ in range(n_default):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            yield batch
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    task_default = VocoderTask(hp_shipped)
    work_default = os.path.join(ROOT, "build", "chip_smoke_train_default")
    shutil.rmtree(work_default, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logmel_gan.launches = groupconv.launches = groupconv.launches_bf16 = 0
    state_default = Trainer(task_default, hp_shipped, work_default).fit(default_batches())
    torch.cuda.synchronize()
    k2_bf16_launches, k2_default_tf32 = groupconv.launches_bf16, groupconv.launches
    k1_default = logmel_gan.launches
    default_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    default_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    with open(os.path.join(work_default, "metrics.jsonl")) as f:
        records_d = [json.loads(line) for line in f]
    if k2_bf16_launches != k2_pred * n_default or k2_default_tf32 \
            or k1_default != k1_pred * n_default:
        fail(f"train_precision {shipped}: launches per step groupconv_bf16 "
             f"{k2_bf16_launches / n_default}, groupconv (3xTF32) {k2_default_tf32 / n_default}, "
             f"logmel_gan {k1_default / n_default}; predicted {k2_pred}, 0, {k1_pred}")
    if sum(r["skipped"] for r in records_d) or not all(
            np.isfinite(v) for r in records_d for v in r.values() if isinstance(v, float)):
        fail(f"train_precision {shipped}: skipped updates or non-finite metrics {records_d}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task_default.train_step(state_default, batch)
        torch.cuda.synchronize()
        default_wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels_d = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    default_device_ms = sum(e.self_device_time_total for e in kernels_d) / 1e3
    bf16_evs = [e for e in kernels_d if "groupconv_bf16_kernel" in e.key]
    if sum(e.count for e in bf16_evs) != k2_pred:
        fail(f"train_precision {shipped}: the profiled step ran groupconv_bf16_kernel "
             f"{sum(e.count for e in bf16_evs)} times, predicted {k2_pred}")
    top_d = sorted(kernels_d, key=lambda e: -e.self_device_time_total)[:6]
    print(f"train {shipped}: the same batch through Trainer.fit at the shipped "
          f"train_precision {shipped!r} (bf16 operands for every dot and conv, K2-bf16 on the "
          f"MSD), {n_default} steps: ms per step {[round(x, 3) for x in default_ms]}, median "
          f"after 1 warmup step {np.median(default_ms[1:]):.3f} (highest's "
          f"{np.median(step_ms[1:]):.3f}); peak memory {default_peak_gb:.3f} GB; launches per "
          f"step groupconv_bf16 {k2_bf16_launches / n_default:g}, groupconv (3xTF32) "
          f"{k2_default_tf32 / n_default:g}, logmel_gan {k1_default / n_default:g}; "
          f"one profiled step: wall {default_wall_ms:.3f} ms, device kernels "
          f"{default_device_ms:.3f} ms (busy {100 * default_device_ms / default_wall_ms:.1f}%), "
          f"{sum(e.count for e in kernels_d)} kernels, K2-bf16 x{sum(e.count for e in bf16_evs)} "
          f"{sum(e.self_device_time_total for e in bf16_evs) / 1e3:.3f} ms; largest: "
          + "; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in top_d)
          + "; step losses: " + ", ".join(f"{k} {v:.5g}" for k, v in records_d[-1].items()
                                           if k not in ("step", "prefix", "skipped",
                                                        "steps_per_s")), flush=True)

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
    # gradient, leaf by leaf; both fp32 steps against the float64 one
    with torch.backends.mkldnn.flags(enabled=False):
        new_64, m_64 = task_cpu.train_step(
            tree_map(lambda t: t.cpu().double() if t.is_floating_point() else t.cpu(),
                     state0), {k: v.cpu().double() for k, v in small.items()})
    mu = {name: {opt: tree_leaves(st[opt]["mu"]) for opt in ("opt_g", "opt_d")}
          for name, st in (("card", new_gpu), ("cpu", new_cpu), ("f64", new_64))}
    errs = {name: {opt: [rel_l2(a.cpu(), b) for a, b in zip(mu[name][opt], mu["f64"][opt])]
                   for opt in ("opt_g", "opt_d")} for name in ("card", "cpu")}
    worst = {name: {opt: max(range(len(e)), key=e.__getitem__) for opt, e in errs[name].items()}
             for name in errs}
    cpu_worst = max(max(e) for e in errs["cpu"].values())
    limit = max(STEP_GRAD_REL, STEP_FP32_FACTOR * cpu_worst)
    past = [f"{opt} leaf {i} {tuple(mu['f64'][opt][i].shape)} {e:.3g}"
            for opt, es in errs["card"].items() for i, e in enumerate(es) if e > limit]
    if past:
        fail(f"card gradient leaves off the CPU's float64 step past {limit:.3g} (the CPU's fp32 "
             f"step's worst leaf {cpu_worst:.3g}): {'; '.join(past)}")
    print(f"train check: one step at B={CHECK_B} on the card ({t_gpu:.2f} s) against the same "
          f"step on the CPU with device='cpu' ({t_cpu:.2f} s, plain versions, oneDNN off): "
          f"loss terms max rel diff {loss_err:.3g} (rtol {STEP_RTOL}); gradient leaves from the "
          f"CPU's float64 step, max rel L2 over {len(errs['card']['opt_g'])} G + "
          f"{len(errs['card']['opt_d'])} D leaves: card G "
          + ", D ".join(f"{errs['card'][o][worst['card'][o]]:.3g} (leaf {worst['card'][o]})"
                        for o in ("opt_g", "opt_d"))
          + ", CPU fp32 G "
          + ", D ".join(f"{errs['cpu'][o][worst['cpu'][o]]:.3g} (leaf {worst['cpu'][o]})"
                        for o in ("opt_g", "opt_d"))
          + f"; limit max({STEP_GRAD_REL}, {STEP_FP32_FACTOR} x the CPU fp32 step's worst) "
          f"{limit:.3g}", flush=True)
    both_mu = lambda st: tree_leaves(st["opt_g"]["mu"]) + tree_leaves(st["opt_d"]["mu"])  # noqa: E731
    print("train rungs: " + rung_check(
        "vocoder", lambda rung: VocoderTask(dict(hp, train_precision=rung)), state0, small, m_64,
        both_mu(new_64), both_mu), flush=True)

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
    bf16_rows, bf16_err, bf16_grad_err = groupconv_bf16_phase(geoms, gen, dev)
    bf16_sum = {key: sum(r[key] for r in bf16_rows)
                for key in ("ms", "kernel_device_ms", "plain_ms", "library_ms", "bound_ms")}
    bf16_by = {by: sum(r["bound_ms"] for r in bf16_rows if r["bound_by"] == by)
               for by in ("bytes", "operations")}
    print(f"train groupconv_bf16 sums over the {len(geoms)} geometries: values max abs "
          f"{bf16_err:.3g} (atol {LOGMEL_ATOL}, rtol {LOGMEL_RTOL}), max rel L2 "
          f"{max(r['rel_l2'] for r in bf16_rows):.3g}; dx/dw max rel L2 {bf16_grad_err:.3g} "
          f"(limit {BF16_GRAD_REL}); kernel {bf16_sum['ms']:.4f} ms (device "
          f"{bf16_sum['kernel_device_ms']:.4f} ms), cuDNN bf16 {bf16_sum['library_ms']:.4f} "
          f"ms, plain {bf16_sum['plain_ms']:.4f} ms, bound {bf16_sum['bound_ms']:.4g} ms "
          f"(3xTF32 K2 {k2_sum['ms']:.4f} ms, device {k2_sum['kernel_device_ms']:.4f} ms)",
          flush=True)
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
        {"name": "groupconv_bf16", "route": "cuda", "source": "conan_tpu_torch/csrc/groupconv.cu",
         "replaces": "conan_tpu/ops/pallas_groupconv.py:56", "launches": k2_bf16_launches,
         "max_abs_err": bf16_err, "max_abs_diff": bf16_err, "ms": bf16_sum["ms"],
         "kernel_device_ms": bf16_sum["kernel_device_ms"], "plain_ms": bf16_sum["plain_ms"],
         "bound_ms": bf16_sum["bound_ms"], "bound_by": max(bf16_by, key=bf16_by.get),
         "library_ms": bf16_sum["library_ms"], "grad_rel_l2": bf16_grad_err,
         "geometries": len(geoms),
         "scale1_layer": {key: bf16_rows[0][key] for key in
                          ("ms", "kernel_device_ms", "plain_ms", "library_ms", "bound_ms")}},
    ]


def conan_corpus(hp, rng: np.random.Generator) -> None:
    """Write the conan_train corpus where ``hp`` says: each utterance's wav,
    its F0 contour per frame as ``<wav dir>_f0/<name>_f0.npy``, random
    content codes 0-99 in ``metadata.json``, and the speaker map."""
    from scipy.io import wavfile

    hop = hp["hop_size"]
    wav_dir = os.path.join(hp["processed_data_dir"], "wavs")
    os.makedirs(wav_dir)
    os.makedirs(wav_dir + "_f0")
    items = []
    for spk in range(CONAN_SPEAKERS):
        for utt in range(CONAN_UTTS):
            name = f"spk{spk}_{utt}"
            n = int(rng.integers(CONAN_FRAMES[0], CONAN_FRAMES[1] + 1))
            wav, f0 = synth_wav(rng, (n * hop - 1) / SR, with_f0=True)
            path = os.path.join(wav_dir, f"{name}.wav")
            wavfile.write(path, SR, wav)
            np.save(os.path.join(wav_dir + "_f0", f"{name}_f0.npy"),
                    f0[np.arange(n) * hop].astype(np.float32))
            items.append({"item_name": name, "wav_fn": path,
                          "hubert": " ".join(map(str, rng.integers(0, 100, n)))})
    with open(os.path.join(hp["processed_data_dir"], "metadata.json"), "w") as f:
        json.dump(items, f)
    with open(os.path.join(hp["processed_data_dir"], "spker_set.json"), "w") as f:
        json.dump({f"spk{i}": i for i in range(CONAN_SPEAKERS)}, f)


def conan_step_check(hp, batch: dict, dev: torch.device, seed: int) -> None:
    """One ConanTask step at small width on the card against the same step on
    the CPU, from one state (the k-means hook run on the card) and one batch,
    with no generator on either side: dropout off and every crop at frame 0.
    Loss terms to the CPU's fp32 step at STEP_RTOL; each gradient leaf (the
    optimizers' first moments, (1 - b1) times the clipped gradient) and each
    leaf of the new VQ state to the CPU's float64 step within max(1e-3, 4 x
    the CPU fp32 step's worst leaf), the vocoder check's rule."""
    hp = dict(hp, **CONAN_CHECK_HP)
    small = {k: np.ascontiguousarray(batch[k][:CHECK_B, :CONAN_CHECK_FRAMES])
             for k in ("content", "mels", "f0", "uv")}
    small["ref_mels"] = np.ascontiguousarray(batch["ref_mels"][:CHECK_B, :CONAN_CHECK_REF])
    task = ConanTask(hp)
    state0, done = task.host_hook(task.init_state(torch.Generator().manual_seed(seed + 1)),
                                  CONAN_CHECK_STEP, small)
    if not done:
        fail("conan check: the k-means hook deferred on its batch")
    state0["step"] = torch.tensor(CONAN_CHECK_STEP, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    new_gpu, m_gpu = task.train_step(state0, small, None, use_random_ref=True)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    task_cpu = ConanTask(hp, device="cpu")
    t0 = time.perf_counter()
    with torch.backends.mkldnn.flags(enabled=False):
        new_cpu, m_cpu = task_cpu.train_step(tree_map(lambda t: t.cpu(), state0), small, None,
                                             use_random_ref=True)
        t_cpu = time.perf_counter() - t0
        new_64, m_64 = task_cpu.train_step(
            tree_map(lambda t: t.cpu().double() if t.is_floating_point() else t.cpu(), state0),
            {k: v.astype(np.float64) if v.dtype.kind == "f" else v for k, v in small.items()},
            None, use_random_ref=True)
    off = [k for k in ("vq_loss", "gloss", "a", "d_r") if float(m_cpu[k]) == 0.0]
    if off:
        fail(f"conan check: gates off at step {CONAN_CHECK_STEP}: {off}")
    loss_err = max(abs(float(m_gpu[k]) - float(m_cpu[k])) / max(abs(float(m_cpu[k])), 1e-30)
                   for k in m_cpu if k != "skipped")
    if loss_err > STEP_RTOL or float(m_gpu["skipped"]) or float(m_cpu["skipped"]):
        fail(f"conan check: card step losses {m_gpu} != CPU step losses {m_cpu} "
             f"(rtol {STEP_RTOL})")
    parts = {"G": lambda st: tree_leaves(st["opt_g"]["mu"]),
             "D": lambda st: tree_leaves(st["opt_d"]["mu"]),
             "VQ": lambda st: [st["vq_state"][k] for k in ("embedding", "ema_count", "ema_weight")]}
    errs = {name: {part: [rel_l2(a.cpu(), b) for a, b in zip(leaves(st), leaves(new_64))]
                   for part, leaves in parts.items()}
            for name, st in (("card", new_gpu), ("cpu", new_cpu))}
    cpu_worst = max(max(e) for e in errs["cpu"].values())
    limit = max(STEP_GRAD_REL, STEP_FP32_FACTOR * cpu_worst)
    past = [f"{part} leaf {i} {e:.3g}" for part, es in errs["card"].items()
            for i, e in enumerate(es) if e > limit]
    if past:
        fail(f"conan check: card leaves off the CPU's float64 step past {limit:.3g} (the CPU's "
             f"fp32 step's worst leaf {cpu_worst:.3g}): {'; '.join(past)}")
    worst = {name: ", ".join(f"{part} {max(es):.3g}" for part, es in e.items())
             for name, e in errs.items()}
    print(f"conan_train check: one step at B={CHECK_B} x {CONAN_CHECK_FRAMES} frames (refs "
          f"{CONAN_CHECK_REF}), hidden {hp['hidden_size']}, nVQ {hp['nVQ']}, step "
          f"{CONAN_CHECK_STEP} (VQ, guided attention, discriminator and random reference on), "
          f"dropout off and crops at frame 0 on both sides: card ({t_gpu:.2f} s) vs CPU "
          f"({t_cpu:.2f} s, oneDNN off) loss terms max rel diff {loss_err:.3g} (rtol "
          f"{STEP_RTOL}); leaves from the CPU's float64 step, max rel L2 over "
          + ", ".join(f"{len(es)} {part}" for part, es in errs["card"].items())
          + f": card {worst['card']}; CPU fp32 {worst['cpu']}; limit max({STEP_GRAD_REL}, "
          f"{STEP_FP32_FACTOR} x the CPU fp32 step's worst) {limit:.3g}", flush=True)
    gd = lambda st: parts["G"](st) + parts["D"](st)  # noqa: E731
    print("conan_train rungs: " + rung_check(
        "conan", lambda rung: ConanTask(dict(hp, train_precision=rung)), state0, small,
        m_64, gd(new_64), gd, use_random_ref=True), flush=True)


def binarized_mels_check(hp, dev: torch.device, n_items: int, phase: str = "conan_train"
                         ) -> tuple[float, list[str]]:
    """Every mel the binarizer stored (K1 on each whole utterance) against
    the plain version on the same wav on the card, cut to the record's
    length, by compare_logmel. Returns the max abs difference and the notes
    on elements held to float64."""
    with open(os.path.join(hp["processed_data_dir"], "metadata.json")) as f:
        wav_fns = {r["item_name"]: r["wav_fn"] for r in json.load(f)}
    mel_cfg = MelConfig.from_hparams(hp)
    err, notes, seen = 0.0, [], 0
    for prefix in ("train", "valid", "test"):
        store = RecordReader(os.path.join(hp["binary_data_dir"], prefix))
        for i in range(len(store)):
            rec = store[i]
            wav = torch.from_numpy(load_wav(wav_fns[rec["item_name"]],
                                            hp["audio_sample_rate"])[None]).to(dev)
            n = rec["len"]
            e, note = compare_logmel(
                f"{phase}: binarized mel of {rec['item_name']} ({n} frames)",
                torch.from_numpy(rec["mel"]).to(dev), logmel_reference(wav, mel_cfg)[0, :n],
                lambda: logmel_reference(wav.double(), mel_cfg)[0, :n])
            err, seen = max(err, e), seen + 1
            notes += [note] if note else []
        store.close()
    if seen != n_items:
        fail(f"{phase}: the record store holds {seen} records for {n_items} utterances")
    return err, notes


def conan_train_phase(seed: int, dev: torch.device) -> int:
    """Phase 6: the Conan acoustic GAN at full width (egs/soak_r5/conan.yaml,
    train_precision highest) from a corpus the port binarizes (K1 on every
    utterance) and batches, through Trainer.fit for CONAN_STEPS steps; then
    the small-width card-vs-CPU check. Returns K1's launches on this path."""
    work = os.path.join(ROOT, "build", "chip_smoke_conan_train")
    shutil.rmtree(work, ignore_errors=True)
    hp = load_config(os.path.join(ROOT, "egs", "soak_r5", "conan.yaml"))
    shipped = hp["train_precision"]
    hp.update(CONAN_GATES, train_precision="highest", max_updates=CONAN_STEPS,
              tb_log_interval=1, seed=seed,
              processed_data_dir=os.path.join(work, "processed"),
              binary_data_dir=os.path.join(work, "binary"))
    t0 = time.perf_counter()
    conan_corpus(hp, np.random.default_rng([seed, 6]))
    synth_s = time.perf_counter() - t0
    logmel.launches = 0
    t0 = time.perf_counter()
    ConanBinarizer(hp).process()
    torch.cuda.synchronize()
    binarize_s = time.perf_counter() - t0
    launches = logmel.launches
    n_items = CONAN_SPEAKERS * CONAN_UTTS
    if launches != n_items:
        fail(f"conan_train: the binarizer launched the logmel kernel {launches} times for "
             f"{n_items} utterances")
    k1_err, k1_notes = binarized_mels_check(hp, dev, n_items)

    task, kind = build_task(hp)
    hooks = []
    hook = task.host_hook

    def timed_hook(state, step, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = hook(state, step, batch)
        torch.cuda.synchronize()
        hooks.append((step, time.perf_counter() - t, out[1]))
        return out

    task.host_hook = timed_hook
    train_iter = build_train_iter(hp, kind)
    events, shapes, last = [], [], {}

    def batches():
        for _ in range(CONAN_STEPS):
            last["batch"] = next(train_iter)
            shapes.append(tuple(last["batch"]["mels"].shape[:2]))
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            yield last["batch"]
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    work_dir = os.path.join(work, "exp")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = Trainer(task, hp, work_dir, use_random_ref_after=use_random_ref_after(hp, kind)
                    ).fit(batches())
    train_iter.close()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if int(state["step"]) != CONAN_STEPS or len(records) != CONAN_STEPS:
        fail(f"conan_train: Trainer.fit ran {int(state['step'])} steps, logged {len(records)}")
    if set(shapes) != {(n_items, CONAN_FRAMES[1])}:
        fail(f"conan_train: batches {shapes}, not B={n_items} x T={CONAN_FRAMES[1]}")
    if not all(np.isfinite(v) for r in records for v in r.values() if isinstance(v, float)):
        fail(f"conan_train: non-finite training metrics: {records}")
    skipped = sum(r["skipped"] for r in records)
    if skipped:
        fail(f"conan_train: {skipped:.0f} of {CONAN_STEPS} updates skipped")
    gates = {"vq_loss": CONAN_GATES["vq_start"] + 1, "a": CONAN_GATES["disc_start_steps"],
             "d_r": CONAN_GATES["disc_start_steps"]}
    wrong = [k for k, first in gates.items()
             if any((r[k] != 0.0) != (i >= first) for i, r in enumerate(records))]
    if wrong or [(s, d) for s, _, d in hooks] != [(CONAN_GATES["vq_start"] + 1, True)] \
            or float(state["vq_state"]["initialized"]) != 1.0:
        fail(f"conan_train: schedule gates {wrong} off their phases, or the k-means hook ran "
             f"{hooks}")

    # one more step under torch.profiler, in the last phase
    batch = last["batch"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.train_step(state, batch, gen, use_random_ref=True)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    last_phase = step_ms[CONAN_GATES["random_speaker_steps"]:]
    losses = ", ".join(f"{k} {v:.5g}" for k, v in records[-1].items()
                       if k not in ("step", "prefix", "skipped", "steps_per_s"))
    print(f"conan_train: egs/soak_r5/conan.yaml at full width (hidden {hp['hidden_size']}, "
          f"nVQ {hp['nVQ']}, {hp['disc_win_num']}-window mel discriminator of hidden "
          f"{hp['mel_disc_hidden_size']}), train_precision highest set over the shipped "
          f"{shipped!r} (fp32, TF32 off), random weights seed {seed}; corpus {n_items} "
          f"synthesized utterances of {CONAN_FRAMES[0]}-{CONAN_FRAMES[1]} frames in "
          f"{synth_s:.2f} s, ConanBinarizer (K1 x{launches}) in {binarize_s:.2f} s, its "
          f"{n_items} stored mels against the plain version on the same wavs: max abs "
          f"{k1_err:.3g} (atol {LOGMEL_ATOL}, rtol {LOGMEL_RTOL})"
          + (f", held to float64: {'; '.join(k1_notes)}" if k1_notes else "") + "; "
          f"build_train_iter batches B x T {shapes[0][0]} x {shapes[0][1]} (max_tokens "
          f"{hp['max_tokens']}); Trainer.fit {CONAN_STEPS} steps (vq_start "
          f"{CONAN_GATES['vq_start']}, forcing {CONAN_GATES['forcing']}, disc_start_steps "
          f"{CONAN_GATES['disc_start_steps']}, random_speaker_steps "
          f"{CONAN_GATES['random_speaker_steps']}): skipped {skipped:.0f}; ms per step (CUDA "
          f"events) {[round(x, 3) for x in step_ms]}, median of steps "
          f"{CONAN_GATES['random_speaker_steps']}-{CONAN_STEPS - 1} (the last phase) "
          f"{np.median(last_phase):.3f}; k-means hook at step {hooks[0][0]} {hooks[0][1]:.3f} s; "
          f"peak memory {peak_gb:.3f} GB; one profiled step: wall {wall_ms:.3f} ms, device "
          f"kernels {device_ms:.3f} ms (busy {100 * device_ms / wall_ms:.1f}%), "
          f"{sum(e.count for e in kernels)} kernels; largest: "
          + "; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in top)
          + f"; step {CONAN_STEPS} losses: {losses}", flush=True)
    rows = step_rows(ConanTask(dict(hp, train_precision=shipped)), state, batch,
                     {"use_random_ref": True}, gen)
    print(f"conan_train {shipped}: the last batch at the shipped rung (bf16 operands for every "
          f"dot and conv) from the trained state, " + step_rows_text(
              shipped, rows, float(np.median(last_phase))), flush=True)
    conan_step_check(hp, batch, dev, seed)
    return launches


def emformer_corpus(hp, rng: np.random.Generator) -> list[str]:
    """Write the emformer_train corpus where ``hp`` says: EMF_SPEAKERS x
    EMF_UTTS training utterances and EMF_VALID_UTTS of the valid speaker
    "val0", each with random codes 0-99 in ``metadata.json``. Returns the
    wav paths."""
    from scipy.io import wavfile

    hop = hp["hop_size"]
    wav_dir = os.path.join(hp["processed_data_dir"], "wavs")
    os.makedirs(wav_dir)
    names = [f"spk{s}_{u}" for s in range(EMF_SPEAKERS) for u in range(EMF_UTTS)]
    names += [f"val0_{u}" for u in range(EMF_VALID_UTTS)]
    items = []
    for name in names:
        n = int(rng.integers(EMF_FRAMES[0], EMF_FRAMES[1] + 1))
        path = os.path.join(wav_dir, f"{name}.wav")
        wavfile.write(path, SR, synth_wav(rng, (n * hop - 1) / SR))
        items.append({"item_name": name, "wav_fn": path,
                      "hubert": " ".join(map(str, rng.integers(0, 100, n)))})
    with open(os.path.join(hp["processed_data_dir"], "metadata.json"), "w") as f:
        json.dump(items, f)
    return [it["wav_fn"] for it in items]


def emformer_step_check(hp, batch: dict, seed: int) -> None:
    """One EmformerTask step at small width (EMF_CHECK over the shipped
    geometry) on the card against the same step on the CPU, from one state
    and two of the corpus's utterances: ce and acc to the CPU's fp32 step at
    STEP_RTOL; each gradient leaf (the first moments) to the CPU's float64
    step within max(1e-3, 4 x the CPU fp32 step's worst leaf)."""
    from conan_tpu_torch.models.emformer import EmformerConfig, EmformerDistillModel
    from conan_tpu_torch.train.tasks import EmformerTask

    cfg = dataclasses.replace(EmformerConfig.from_hparams(hp), **EMF_CHECK)
    rc = cfg.right_context_length
    small = {"mels": np.ascontiguousarray(batch["mels"][:CHECK_B, :EMF_CHECK_FRAMES + rc]),
             "content": np.ascontiguousarray(batch["content"][:CHECK_B, :EMF_CHECK_FRAMES])}
    tasks = {}
    for device in (None, "cpu"):
        tasks[device] = EmformerTask(hp, device=device)
        tasks[device].model = EmformerDistillModel(cfg)
    state0 = tasks[None].init_state(torch.Generator().manual_seed(seed + 2))
    new_gpu, m_gpu = tasks[None].train_step(state0, small)
    new_cpu, m_cpu = tasks["cpu"].train_step(tree_map(lambda t: t.cpu(), state0), small)
    new_64, m_64 = tasks["cpu"].train_step(
        tree_map(lambda t: t.cpu().double() if t.is_floating_point() else t.cpu(), state0),
        dict(small, mels=small["mels"].astype(np.float64)))
    loss_err = max(abs(float(m_gpu[k]) - float(m_cpu[k])) / max(abs(float(m_cpu[k])), 1e-30)
                   for k in ("ce", "acc"))
    if loss_err > STEP_RTOL or float(m_gpu["skipped"]) or float(m_cpu["skipped"]):
        fail(f"emformer check: card step {m_gpu} != CPU step {m_cpu} (rtol {STEP_RTOL})")
    errs = {name: [rel_l2(a.cpu(), b) for a, b in zip(tree_leaves(st["opt"]["mu"]),
                                                      tree_leaves(new_64["opt"]["mu"]))]
            for name, st in (("card", new_gpu), ("cpu", new_cpu))}
    limit = max(STEP_GRAD_REL, STEP_FP32_FACTOR * max(errs["cpu"]))
    past = [f"leaf {i} {e:.3g}" for i, e in enumerate(errs["card"]) if e > limit]
    if past:
        fail(f"emformer check: card leaves off the CPU's float64 step past {limit:.3g}: "
             + "; ".join(past))
    print(f"emformer_train check: one step at B={CHECK_B} x {EMF_CHECK_FRAMES} frames of the "
          f"corpus, {cfg.num_layers} layers of FFN {cfg.ffn_dim} (input {cfg.input_dim}, "
          f"{cfg.num_heads} heads): card vs CPU ce/acc max rel diff {loss_err:.3g} (rtol "
          f"{STEP_RTOL}); {len(errs['card'])} gradient leaves from the CPU's float64 step, max "
          f"rel L2: card {max(errs['card']):.3g}, CPU fp32 {max(errs['cpu']):.3g}; limit "
          f"{limit:.3g}", flush=True)

    def rung_task(rung):
        task = EmformerTask(dict(hp, train_precision=rung))
        task.model = EmformerDistillModel(cfg)
        return task

    mu = lambda st: tree_leaves(st["opt"]["mu"])  # noqa: E731
    print("emformer_train rungs: " + rung_check("emformer", rung_task, state0, small, m_64,
                                                mu(new_64), mu), flush=True)


def emformer_step_times(task, state: dict, batch: dict, n_warm: int, n_timed: int
                        ) -> tuple[list[float], float]:
    """ms of ``n_timed`` train steps on ``batch`` by CUDA events after
    ``n_warm`` untimed ones, and the peak memory of those steps in GB."""
    for _ in range(n_warm):
        state, _ = task.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_timed + 1)]
    events[0].record()
    for i in range(n_timed):
        state, _ = task.train_step(state, batch)
        events[i + 1].record()
    torch.cuda.synchronize()
    return ([a.elapsed_time(b) for a, b in zip(events, events[1:])],
            torch.cuda.max_memory_allocated() / 1e9)


def emformer_train_phase(seed: int, dev: torch.device, smi: str, dirs, src: np.ndarray,
                         ref: np.ndarray) -> int:
    """Phase 7: the Emformer distillation through the port's CLIs at full
    width (egs/soak_r5/emformer.yaml, train_precision highest): the binarize
    CLI (K1 once an utterance), the training CLI with validation, periodic
    checkpoints, a resumed run and --validate; then the engine serving from
    the trained work dir; the step's times at the packed shape and at the
    longest rung; the small-width card-vs-CPU check. Returns K1's launches
    on this path (the binarizer's and the serving's)."""
    import contextlib
    import io

    from conan_tpu_torch.checkpoint import (get_all_checkpoints, get_last_checkpoint,
                                            params_from_jax)
    from conan_tpu_torch.data import run_binarize
    from conan_tpu_torch.models import emformer as emformer_mod
    from conan_tpu_torch.train import run as train_run

    work = os.path.join(ROOT, "build", "chip_smoke_emformer_train")
    shutil.rmtree(work, ignore_errors=True)
    config = os.path.join(ROOT, "egs", "soak_r5", "emformer.yaml")
    shipped = load_config(config)["train_precision"]
    corpus = (f"processed_data_dir={work}/processed,binary_data_dir={work}/binary,"
              f"valid_prefixes=[val0],test_prefixes=[]")
    hp = load_config(config)
    hp.update(processed_data_dir=f"{work}/processed", binary_data_dir=f"{work}/binary",
              valid_prefixes=["val0"], test_prefixes=[], train_precision="highest", seed=seed)
    t0 = time.perf_counter()
    emformer_corpus(hp, np.random.default_rng([seed, 7]))
    synth_s = time.perf_counter() - t0
    n_items = EMF_SPEAKERS * EMF_UTTS + EMF_VALID_UTTS

    logmel.launches = 0
    t0 = time.perf_counter()
    run_binarize.main(["--config", config, "--hparams", corpus])
    torch.cuda.synchronize()
    binarize_s = time.perf_counter() - t0
    bin_launches = logmel.launches
    if bin_launches != n_items:
        fail(f"emformer_train: the binarizer launched the logmel kernel {bin_launches} times "
             f"for {n_items} utterances")
    k1_err, k1_notes = binarized_mels_check(hp, dev, n_items, "emformer_train")
    train_iter = build_train_iter(hp, "emformer")
    packed = [next(train_iter) for _ in range(4)]
    train_iter.close()
    shapes = {tuple(b["mels"].shape[:2]) for b in packed}
    # what max_tokens counts: B x the longest item (its codes before the
    # collate masked its last rc)
    rc = hp["right_context"]
    tokens = [len(b["content"]) * int(((b["content"] != -1).sum(1) + rc).max()) for b in packed]

    exp = os.path.join(work, "exp")
    argv = ["--config", config, "--exp_name", exp, "--hparams",
            f"{corpus},train_precision=highest,max_updates={EMF_STEPS},"
            f"val_check_interval={EMF_VAL_EVERY},num_ckpt_keep=1,tb_log_interval=1,seed={seed}"]
    t0 = time.perf_counter()
    train_run.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    first = get_all_checkpoints(exp)
    t0 = time.perf_counter()
    train_run.main(["--exp_name", exp, "--hparams", f"max_updates={EMF_RESUMED}"])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_run.main(["--exp_name", exp, "--validate"])
    validated = json.loads(out.getvalue().strip().splitlines()[-1])
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    tr = [r for r in records if r["prefix"] == "tr"]
    val = [r for r in records if r["prefix"] == "val"]
    ckpts = [os.path.basename(p) for p in get_all_checkpoints(exp)]
    if [os.path.basename(p) for p in first] != [f"model_ckpt_steps_{EMF_STEPS}.ckpt"]:
        fail(f"emformer_train: the first run left {first}")
    if [r["step"] for r in tr] != list(range(1, EMF_RESUMED + 1)):
        fail(f"emformer_train: the runs logged steps {[r['step'] for r in tr]}, not 1-"
             f"{EMF_RESUMED} (the second resumed at step {EMF_STEPS})")
    if [r["step"] for r in val] != list(range(EMF_VAL_EVERY, EMF_RESUMED + 1, EMF_VAL_EVERY)):
        fail(f"emformer_train: validations at {[r['step'] for r in val]}")
    if ckpts != [f"model_ckpt_steps_{EMF_RESUMED}.ckpt"] or validated["step"] != EMF_RESUMED:
        fail(f"emformer_train: checkpoints {ckpts}, --validate read step {validated['step']}")
    bad = [r for r in tr + val if not all(np.isfinite(r[k]) for k in ("ce", "acc"))]
    skipped = sum(r["skipped"] for r in tr)
    if bad or skipped:
        fail(f"emformer_train: {skipped:.0f} updates skipped, non-finite metrics {bad}")
    if shapes != {(16, 530)}:
        fail(f"emformer_train: the loader packed B x T_in {shapes}, not 16 x 530")

    # the engine serves from the trained work dir
    eng = build_engine(dirs[0], exp, dirs[2], serving_precision="exact")
    wav_s, codes_s = eng.infer_once(src, ref, collect_codes=True)
    wav_o, codes_o = eng.infer_offline(src, ref, collect_codes=True)
    torch.cuda.synchronize()
    launches = logmel.launches
    serve_err = float(np.abs(wav_s - wav_o).max())
    if not np.array_equal(codes_s, codes_o) or serve_err > STREAM_ATOL \
            or not np.isfinite(wav_s).all():
        fail(f"emformer_train: serving from the trained dir, streaming vs offline max abs "
             f"{serve_err:.3g}, codes equal {np.array_equal(codes_s, codes_o)}")

    # the step's times at the packed shape, from the trained state
    task, _ = build_task(hp)
    ckpt, _ = get_last_checkpoint(exp)
    state = params_from_jax(ckpt["state"], dev)
    step_ms, peak_gb = emformer_step_times(task, state, packed[0], EMF_WARM, EMF_TIMED)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.train_step(state, packed[0], gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]

    # the longest rung: the mask built once, then the step
    B, T = EMF_LONG
    rng = np.random.default_rng([seed, 8])
    seg = task.cfg.segment_length
    long_batch = {"mels": (rng.standard_normal((B, T + rc, 80)) - 4).astype(np.float32),
                  "content": rng.integers(0, 100, (B, T))}
    long_batch["content"][:, T - rc:] = -1
    emformer_mod._offline_mask.cache_clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mask = task.model.emformer.offline_mask(T // seg, dev)
    torch.cuda.synchronize()
    mask_ms = 1e3 * (time.perf_counter() - t0)
    long_ms, long_peak_gb = emformer_step_times(task, state, long_batch, 1, 3)
    n_k = mask.shape[0]

    B_p, T_p = packed[0]["mels"].shape[:2]
    print(f"emformer_train: {smi}; egs/soak_r5/emformer.yaml at full width "
          f"({hp['emformer_layers']} layers, input {task.cfg.input_dim}, {task.cfg.num_heads} "
          f"heads of dim {task.cfg.head_dim}, FFN {task.cfg.ffn_dim}, segment {seg}, left context "
          f"{task.cfg.left_context_length}, right context {rc}, {task.cfg.output_dim}-way head), "
          f"train_precision highest set over the shipped {shipped!r}, seed {seed}; corpus "
          f"{n_items} synthesized utterances of {EMF_FRAMES[0]}-{EMF_FRAMES[1]} frames in "
          f"{synth_s:.2f} s; run_binarize.main (EmformerBinarizer, K1 x{bin_launches}) in "
          f"{binarize_s:.2f} s, its {n_items} stored mels against the plain version: max abs "
          f"{k1_err:.3g} (atol {LOGMEL_ATOL}, rtol {LOGMEL_RTOL})"
          + (f", held to float64: {'; '.join(k1_notes)}" if k1_notes else "") + "; "
          f"build_train_iter packs B x T_in {sorted(shapes)} (B x the longest item: {tokens}, "
          f"max_tokens {hp['max_tokens']}); train.run.main {EMF_STEPS} steps in "
          f"{train_s:.2f} s, resumed to {EMF_RESUMED} in {resume_s:.2f} s (steps "
          f"{tr[EMF_STEPS]['step']}-{tr[-1]['step']} logged by the second run), validations at "
          f"{[r['step'] for r in val]}, checkpoints left {ckpts}, skipped {skipped:.0f}; step "
          f"1 ce {tr[0]['ce']:.5g} acc {tr[0]['acc']:.4g}, step {EMF_RESUMED} ce "
          f"{tr[-1]['ce']:.5g} acc {tr[-1]['acc']:.4g}; --validate {json.dumps(validated)}; "
          f"served from the trained dir: streaming vs offline max abs {serve_err:.3g} (atol "
          f"{STREAM_ATOL}), codes equal, K1 x{launches} on this path "
          f"({launches - bin_launches} serving); step at B x T_in {B_p} x {T_p} (n_q = n_k = "
          f"{(T_p - rc) * (seg + rc) // seg}): "
          f"ms (CUDA events, {EMF_TIMED} after {EMF_WARM} warm) {[round(x, 3) for x in step_ms]}, "
          f"median {np.median(step_ms):.3f}; peak memory {peak_gb:.3f} GB; one profiled step: "
          f"wall {wall_ms:.3f} ms, device kernels {device_ms:.3f} ms (busy "
          f"{100 * device_ms / wall_ms:.1f}%), {sum(e.count for e in kernels)} kernels; largest: "
          + "; ".join(f"{e.key[:50]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in top)
          + f"; longest rung B x T {B} x {T} (n_q = n_k = {n_k}, mask {n_k * n_k * 4 / 1e6:.1f} "
          f"MB built in {mask_ms:.3f} ms): step ms {[round(x, 3) for x in long_ms]}, median "
          f"{np.median(long_ms):.3f}, peak memory {long_peak_gb:.3f} GB", flush=True)
    rows = step_rows(build_task(dict(hp, train_precision=shipped))[0], state, packed[0], {}, gen)
    print(f"emformer_train {shipped}: B x T_in {B_p} x {T_p} at the shipped rung from the "
          f"trained state, " + step_rows_text(shipped, rows, float(np.median(step_ms))),
          flush=True)
    emformer_step_check(hp, packed[0], seed)
    return launches


def postnet_step_check(hp, batch: dict, seed: int) -> None:
    """One PostnetTask step at small width (CONAN_CHECK_HP for the frozen
    Conan, POST_CHECK for the DiffNet, random frozen weights and VQ state) on
    the card against the same step on the CPU at "highest", from one state
    and batch, the flow's draws from one CPU generator seeded alike on both
    sides: the loss to the CPU's fp32 step at STEP_RTOL; each gradient leaf
    (the first moments) to the CPU's float64 step within max(1e-3, 4 x the
    CPU fp32 step's worst leaf); then the "default" and "high" rungs."""
    from conan_tpu_torch.models.conan.model import Conan, ConanConfig
    from conan_tpu_torch.train.tasks import PostnetTask

    hp = dict(hp, **CONAN_CHECK_HP, **POST_CHECK, train_precision="highest")
    gen = torch.Generator().manual_seed(seed + 3)
    conan = Conan(ConanConfig.from_hparams(hp))
    frozen = tree_map(lambda t: t.numpy(), conan.init(gen))
    vq = tree_map(lambda t: t.numpy(), conan.init_vq_state(gen))
    vq["initialized"] = np.ones((), np.float32)
    small = {k: np.ascontiguousarray(batch[k][:CHECK_B, :CONAN_CHECK_FRAMES])
             for k in ("content", "mels", "f0", "uv")}
    small["ref_mels"] = np.ascontiguousarray(batch["ref_mels"][:CHECK_B, :CONAN_CHECK_REF])
    tasks = {d: PostnetTask(hp, frozen, vq, device=d) for d in (None, "cpu")}
    draws = tasks["cpu"].postnet.flow.draws
    for task in tasks.values():        # the same t and x0 on both devices
        task.postnet.flow.draws = (lambda x1, g: tuple(
            t.to(x1.device) for t in draws(x1.cpu(), torch.Generator().manual_seed(seed))))
    state0 = tasks[None].init_state(torch.Generator().manual_seed(seed + 4))
    new_gpu, m_gpu = tasks[None].train_step(state0, small)
    cpu_state = tree_map(lambda t: t.cpu(), state0)
    with torch.backends.mkldnn.flags(enabled=False):
        new_cpu, m_cpu = tasks["cpu"].train_step(cpu_state, small)
        new_64, m_64 = tasks["cpu"].train_step(
            tree_map(lambda t: t.double() if t.is_floating_point() else t, cpu_state),
            {k: v.astype(np.float64) if v.dtype.kind == "f" else v for k, v in small.items()})
    loss_err = abs(float(m_gpu["flow"]) - float(m_cpu["flow"])) / abs(float(m_cpu["flow"]))
    if loss_err > STEP_RTOL or float(m_gpu["skipped"]) or float(m_cpu["skipped"]):
        fail(f"postnet check: card step {m_gpu} != CPU step {m_cpu} (rtol {STEP_RTOL})")
    mu = lambda st: tree_leaves(st["opt"]["mu"])  # noqa: E731
    errs = {name: [rel_l2(a.cpu(), b) for a, b in zip(mu(st), mu(new_64))]
            for name, st in (("card", new_gpu), ("cpu", new_cpu))}
    limit = max(STEP_GRAD_REL, STEP_FP32_FACTOR * max(errs["cpu"]))
    past = [f"leaf {i} {e:.3g}" for i, e in enumerate(errs["card"]) if e > limit]
    if past:
        fail(f"postnet check: card leaves off the CPU's float64 step past {limit:.3g}: "
             + "; ".join(past))

    def rung_task(rung):
        task = PostnetTask(dict(hp, train_precision=rung), frozen, vq)
        task.postnet.flow.draws = tasks[None].postnet.flow.draws
        return task

    rungs = rung_check("postnet", rung_task, state0, small, m_64, mu(new_64), mu)
    print(f"postnet_train check: one step at B={CHECK_B} x {CONAN_CHECK_FRAMES} frames, frozen "
          f"Conan hidden {hp['hidden_size']}, DiffNet {hp['residual_layers']}x"
          f"{hp['residual_channels']}: card vs CPU flow loss rel diff {loss_err:.3g} (rtol "
          f"{STEP_RTOL}); {len(errs['card'])} gradient leaves from the CPU's float64 step, max "
          f"rel L2: card {max(errs['card']):.3g}, CPU fp32 {max(errs['cpu']):.3g}; limit "
          f"{limit:.3g}; {rungs}", flush=True)


def postnet_train_phase(seed: int, dev: torch.device, smi: str) -> None:
    """Phase 8: the mel postnet as shipped (egs/soak_r5/postnet.yaml: a
    20x256 DiffNet, train_precision default) through the port's CLIs on
    conan_train's corpus and trained work dir (fs2_ckpt_dir): spec_stats,
    POST_STEPS steps, resumed to POST_RESUMED; a step timed on the phase's
    first batch; the small-width card-vs-CPU check."""
    import contextlib
    import io

    from conan_tpu_torch.checkpoint import get_all_checkpoints, get_last_checkpoint, \
        params_from_jax
    from conan_tpu_torch.data import spec_stats
    from conan_tpu_torch.train import run as train_run

    conan_work = os.path.join(ROOT, "build", "chip_smoke_conan_train")
    work = os.path.join(ROOT, "build", "chip_smoke_postnet_train")
    shutil.rmtree(work, ignore_errors=True)
    config = os.path.join(ROOT, "egs", "soak_r5", "postnet.yaml")
    shipped = load_config(config)
    corpus = (f"binary_data_dir={conan_work}/binary,processed_data_dir={conan_work}/processed,"
              f"fs2_ckpt_dir={conan_work}/exp")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        spec_stats.main(["--config", config, "--hparams", corpus])
    stats_s = time.perf_counter() - t0
    stats = np.load(os.path.join(conan_work, "binary", "spec_stats.npz"))
    exp = os.path.join(work, "exp")
    t0 = time.perf_counter()
    train_run.main(["--config", config, "--exp_name", exp, "--hparams",
                    f"{corpus},max_updates={POST_STEPS},val_check_interval={POST_STEPS},"
                    f"num_ckpt_keep=1,tb_log_interval=1,seed={seed}"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_run.main(["--exp_name", exp, "--hparams", f"max_updates={POST_RESUMED}"])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        tr = [r for r in map(json.loads, f) if r["prefix"] == "tr"]
    ckpts = [os.path.basename(p) for p in get_all_checkpoints(exp)]
    if [r["step"] for r in tr] != list(range(1, POST_RESUMED + 1)) \
            or ckpts != [f"model_ckpt_steps_{POST_RESUMED}.ckpt"]:
        fail(f"postnet_train: logged steps {[r['step'] for r in tr]}, checkpoints {ckpts}")
    if sum(r["skipped"] for r in tr) or not all(np.isfinite(r["flow"]) for r in tr):
        fail(f"postnet_train: skipped updates or non-finite losses {tr}")

    hp = set_hparams(argv=["--exp_name", exp], save=False)
    task, kind = build_task(hp)
    if kind != "postnet" or task.precision != shipped["train_precision"] or not np.allclose(
            task.postnet.cfg.spec_min, stats["spec_min"]):
        fail(f"postnet_train: the work dir's task is {kind} at {task.precision}, spec_min from "
             f"spec_stats.npz {np.allclose(task.postnet.cfg.spec_min, stats['spec_min'])}")
    train_iter = build_train_iter(hp, kind)
    batch = next(train_iter)
    train_iter.close()
    ckpt, _ = get_last_checkpoint(exp)
    rows = step_rows(task, params_from_jax(ckpt["state"], dev), batch, {},
                     torch.Generator(device=dev).manual_seed(seed))
    print(f"postnet_train: {smi}; egs/soak_r5/postnet.yaml as shipped (DiffNet "
          f"{hp['residual_layers']}x{hp['residual_channels']} over {hp['audio_num_mel_bins']} "
          f"mels, K_step {hp['K_step']}, train_precision {task.precision}) on conan_train's "
          f"corpus and trained Conan (fs2_ckpt_dir), seed {seed}: spec_stats in {stats_s:.2f} s "
          f"(spec_min {float(stats['spec_min'].min()):.3f}..{float(stats['spec_min'].max()):.3f}"
          f", spec_max {float(stats['spec_max'].min()):.3f}.."
          f"{float(stats['spec_max'].max()):.3f}); train.run.main {POST_STEPS} steps in "
          f"{train_s:.2f} s, resumed to {POST_RESUMED} in {resume_s:.2f} s, checkpoints left "
          f"{ckpts}; flow loss step 1 {tr[0]['flow']:.5g}, step {POST_RESUMED} "
          f"{tr[-1]['flow']:.5g}; step at B x T {tuple(batch['mels'].shape[:2])}: "
          + step_rows_text(task.precision, rows), flush=True)
    postnet_step_check(task.hp, batch, seed)


def scan_timings(eng, src: np.ndarray, ref: np.ndarray, bucket_lengths: bool) -> dict:
    """The captured loop's numbers for one utterance (its graph captured
    already): ms per replayed chunk by CUDA events (copy in, replay), and
    under torch.profiler over one stream_scan call the kernels and device ms
    per chunk and the busy share."""
    with torch.inference_mode():
        src_mel = eng.wav_to_mel(src)
        style = eng._prepare(eng.wav_to_mel(ref))
        mel_ext, _T, T_pad = eng._source_chunks(src_mel, bucket_lengths)
        noise = eng._f0_noise(1, T_pad, None, None)
        chunks, noise_chunks = eng.scan_inputs(mel_ext, noise)
        state = eng.init_state(1)
        cap = eng._captured_step(state, chunks[0], style, noise_chunks[0])
        n = chunks.shape[0]
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(n)]
        for (a, b), chunk, nc in zip(events, chunks, noise_chunks):
            a.record()
            cap.mel.copy_(chunk)
            cap.noise.copy_(nc)
            cap.graph.replay()
            b.record()
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in events]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.stream_scan(state, chunks, style, noise_chunks)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset", "stage:"))]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"chunks": n, "median_ms": float(np.median(ms)),
            "p90_ms": float(np.percentile(ms, 90)),
            "kernels_per_chunk": sum(e.count for e in kernels) / n,
            "device_ms_per_chunk": device_ms / n, "wall_ms_per_chunk": wall_ms / n,
            "busy": device_ms / wall_ms}


def eager_chunk_timings(eng, src: np.ndarray, ref: np.ndarray, n_chunks: int) -> dict:
    """The eager loop's ms per chunk (CUDA events around each step, after one
    warm step) and its kernels per chunk (torch.profiler over one step)."""
    seg, rc = eng.cfg.seg, eng.cfg.rc
    with torch.inference_mode():
        src_mel = eng.wav_to_mel(src)
        style = eng._prepare(eng.wav_to_mel(ref))
        mel_ext, _T, T_pad = eng._source_chunks(src_mel)
        noise = eng._f0_noise(1, T_pad, None, None)
        state = eng.init_state(1)
        ms = []
        for i, s in enumerate(range(0, (n_chunks + 1) * seg, seg)):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            _w, _c, state = eng._chunk_step(state, mel_ext[:, s:s + seg + rc], style,
                                            noise[:, s:s + seg])
            b.record()
            torch.cuda.synchronize()
            if i:
                ms.append(a.elapsed_time(b))
        s = (n_chunks + 1) * seg
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng._chunk_step(state, mel_ext[:, s:s + seg + rc], style, noise[:, s:s + seg])
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset", "stage:"))]
    return {"median_ms": float(np.median(ms)), "kernels_per_chunk": sum(e.count for e in kernels),
            "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3}


def scan_phase(eng, dirs, src: np.ndarray, ref: np.ndarray) -> int:
    """Phase 4b: the r5 engine through the captured loop. Returns K1's
    launches on this path."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logmel.launches = 0
    t0 = time.perf_counter()
    wav_c, codes_c = eng.infer_once(src, ref, collect_codes=True, use_scan=True,
                                    bucket_lengths=True)
    first_s = time.perf_counter() - t0
    launches = logmel.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wav_e, codes_e = eng.infer_once(src, ref, collect_codes=True, bucket_lengths=True)
    wav_o, codes_o = eng.infer_offline(src, ref, collect_codes=True, bucket_lengths=True)
    if not np.isfinite(wav_c).all() or wav_c.shape != wav_e.shape:
        fail(f"captured loop: shape {wav_c.shape} / {wav_e.shape} or non-finite waveform")
    err_e, err_o = float(np.abs(wav_c - wav_e).max()), float(np.abs(wav_c - wav_o).max())
    if not (np.array_equal(codes_c, codes_e) and np.array_equal(codes_c, codes_o)):
        fail("captured loop: codes differ from the eager loop's or offline")
    if err_e > CAPTURED_ATOL or err_o > STREAM_ATOL:
        fail(f"captured loop: max abs {err_e:.3g} from eager (atol {CAPTURED_ATOL}), "
             f"{err_o:.3g} from offline (atol {STREAM_ATOL})")
    if launches != 2:
        fail(f"infer_once(use_scan=True) launched the logmel kernel {launches} times, not 2")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.infer_once(src, ref, use_scan=True, bucket_lengths=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rtf = warm_s / (len(src) / SR)
    # the reference is never padded: another reference length is another capture
    n_captured = len(eng._captured)
    t0 = time.perf_counter()
    eng.infer_once(src, ref[:len(ref) - 3 * 320], use_scan=True, bucket_lengths=True)
    torch.cuda.synchronize()
    capture_ms = 1e3 * (time.perf_counter() - t0 - warm_s)
    if len(eng._captured) != n_captured + 1:
        fail(f"captured loop: a new reference length made {len(eng._captured) - n_captured} "
             f"captures, not 1")
    t = scan_timings(eng, src, ref, bucket_lengths=True)
    print(f"scan: r5 geometry, exact, B=1, infer_once(use_scan=True, bucket_lengths=True): "
          f"{t['chunks']} chunks (bucketed), {len(eng._captured)} capture(s), first call "
          f"{first_s:.2f} s with the capture; vs eager loop max abs {err_e:.3g} (atol "
          f"{CAPTURED_ATOL}), vs offline {err_o:.3g} (atol {STREAM_ATOL}), codes equal; "
          f"logmel launches {launches}; replay ms per chunk (CUDA events, copy in + replay) "
          f"median {t['median_ms']:.3f} p90 {t['p90_ms']:.3f}; RTF {rtf:.4f}; peak memory "
          f"{peak_gb:.3f} GB; under torch.profiler over one stream_scan: "
          f"{t['kernels_per_chunk']:.0f} kernels/chunk, device {t['device_ms_per_chunk']:.3f} "
          f"ms/chunk, wall {t['wall_ms_per_chunk']:.3f} ms/chunk (busy "
          f"{100 * t['busy']:.1f}%); a reference 3 frames shorter: one more capture, "
          f"{capture_ms:.1f} ms over the warm call", flush=True)
    wav_x, codes_x = wav_c, codes_c
    for rung in ("high", "fast"):
        e = build_engine(*dirs, serving_precision=rung)
        wav_e, codes_e = e.infer_once(src, ref, collect_codes=True, bucket_lengths=True)
        wav_c, codes_c = e.infer_once(src, ref, collect_codes=True, use_scan=True,
                                      bucket_lengths=True)
        if not np.array_equal(codes_c, codes_e) or not np.isfinite(wav_c).all():
            fail(f"captured loop, {rung}: codes differ from its eager loop or non-finite wav")
        t = scan_timings(e, src, ref, bucket_lengths=True)
        print(f"scan {rung}: against exact (captured) SNR {snr_db(wav_c, wav_x):.2f} dB, max "
              f"abs {float(np.abs(wav_c - wav_x).max()):.3g}, code flips "
              f"{int((codes_c != codes_x).sum())} of {codes_x.size}; captured vs its eager loop "
              f"max abs {float(np.abs(wav_c - wav_e).max()):.3g}, codes equal; replay ms per chunk "
              f"median {t['median_ms']:.3f} p90 {t['p90_ms']:.3f}; "
              f"{t['kernels_per_chunk']:.0f} kernels/chunk, device "
              f"{t['device_ms_per_chunk']:.3f} ms/chunk (busy {100 * t['busy']:.1f}%)",
              flush=True)
    return launches


def flow_phase(seed: int, src: np.ndarray, ref: np.ndarray) -> int:
    """Phase 4c: the rectified-flow F0 configuration at full width with the
    r5 Emformer and vocoder, random weights from the seed. The DiffNet's
    output head is zero at init (as in the reference), which would leave the
    flow's velocity 0; it gets seeded random weights so that the F0 moves.
    Returns K1's launches on this path."""
    hparams = {"conan": load_config(os.path.join(ROOT, "egs", "conan_emformer_flow.yaml")),
               **{name: load_config(os.path.join(ROOT, "egs", "soak_r5", f"{name}.yaml"))
                  for name in ("emformer", "vocoder")}}
    dirs = write_random_checkpoints(os.path.join(ROOT, "build", "chip_smoke_flow_ckpt"),
                                    hparams, seed=seed)
    eng = build_engine(*dirs, serving_precision="exact")
    c = eng.cfg.conan
    head = eng.p_conan["f0_net"]["out_proj"]
    head["w"] = 0.3 * torch.randn(head["w"].shape,
                                  generator=torch.Generator().manual_seed(seed)).to(head["w"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logmel.launches = 0
    t0 = time.perf_counter()
    wav_e, codes_e = eng.infer_once(src, ref, collect_codes=True)
    eager_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wav_c, codes_c = eng.infer_once(src, ref, collect_codes=True, use_scan=True)
    first_s = time.perf_counter() - t0
    wav_o, codes_o = eng.infer_offline(src, ref, collect_codes=True)
    launches = logmel.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not (np.array_equal(codes_e, codes_c) and np.array_equal(codes_e, codes_o)):
        fail("flow: codes of the eager loop, the captured loop and offline differ")
    err_c, err_o = float(np.abs(wav_c - wav_e).max()), float(np.abs(wav_o - wav_e).max())
    if not np.isfinite(wav_e).all() or max(err_c, err_o) > STREAM_ATOL:
        fail(f"flow: captured {err_c:.3g}, offline {err_o:.3g} from the eager loop "
             f"(atol {STREAM_ATOL})")
    if launches != 6:
        fail(f"flow: the logmel kernel launched {launches} times in 3 conversions, not 6")
    # F0: the chunk loop's against offline, from the same codes and noise
    seg = eng.cfg.seg
    with torch.inference_mode():
        mel_ext, _T, T_pad = eng._source_chunks(eng.wav_to_mel(src))
        with precision_scope("exact", eng.device):
            codes = torch.argmax(eng.emformer.apply(eng.p_emformer, mel_ext), dim=-1)
            style = eng._prepare(eng.wav_to_mel(ref))
            noise = eng._f0_noise(1, T_pad, None, None)
            f0_off = eng.conan.decode(eng.p_conan, codes, style, noise)["f0_denorm_pred"]
            state = eng.conan.init_stream_state(1, eng.device)
            f0s = []
            for s in range(0, T_pad, seg):
                r, state = eng.conan.stream_step(eng.p_conan, state, codes[:, s:s + seg], style,
                                                 noise[:, s:s + seg])
                f0s.append(r["f0_denorm_pred"])
    f0_stream = torch.cat(f0s, 1)
    voiced = float((f0_off > 0).float().mean())
    f0_err = float((f0_stream - f0_off).abs().max())
    if not torch.allclose(f0_stream, f0_off, atol=F0_ATOL, rtol=F0_RTOL):
        fail(f"flow: streaming F0 {f0_err:.3g} from offline (atol {F0_ATOL}, rtol {F0_RTOL})")
    eager = eager_chunk_timings(eng, src, ref, n_chunks=FLOW_EAGER_CHUNKS)
    cap = scan_timings(eng, src, ref, bucket_lengths=False)
    print(f"flow: egs/conan_emformer_flow.yaml (hidden {c.hidden_size}, DiffNet "
          f"{c.f0_residual_layers}x{c.f0_residual_channels}, K = {c.f0_k_step} of "
          f"{c.f0_timesteps}) with the r5 Emformer and vocoder, random weights seed {seed}, "
          f"exact, B=1: eager loop {eager_s:.2f} s, captured loop first call {first_s:.2f} s "
          f"with the capture; captured vs eager max abs {err_c:.3g}, offline vs eager "
          f"{err_o:.3g} (atol {STREAM_ATOL}), codes equal; F0 streaming vs offline max abs "
          f"{f0_err:.3g} (atol {F0_ATOL}, rtol {F0_RTOL}), voiced {100 * voiced:.1f}% of "
          f"frames; logmel launches {launches}; eager call {1e3 * eager_s / cap['chunks']:.3f} "
          f"ms/chunk over its {cap['chunks']} chunks (wall, frontend and style included); "
          f"eager chunk median over {FLOW_EAGER_CHUNKS} chunks {eager['median_ms']:.3f} ms "
          f"(CUDA events), {eager['kernels_per_chunk']} kernels/chunk, {eager['device_ms']:.3f} "
          f"device ms/chunk ({100 * eager['device_ms'] / eager['median_ms']:.1f}% of the "
          f"median); captured replay median {cap['median_ms']:.3f} ms p90 "
          f"{cap['p90_ms']:.3f} ms, {cap['kernels_per_chunk']:.0f} kernels/chunk, device "
          f"{cap['device_ms_per_chunk']:.3f} ms/chunk (busy {100 * cap['busy']:.1f}%); peak "
          f"memory {peak_gb:.3f} GB", flush=True)
    return launches


def run_vc_phase(eng, dirs, rng: np.random.Generator) -> int:
    """Phase 4d: run_vc's main with the CLI's argv on two synthesized pairs,
    the r5 random checkpoints with vocoder_denoise_c set by --hparams.
    Returns K1's launches on this path."""
    work = os.path.join(ROOT, "build", "chip_smoke_run_vc")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    pairs = []
    for i, (s_sec, r_sec) in enumerate(((3.3, 2.0), (1.7, 2.9))):
        paths = [os.path.join(work, f"{kind}{i}.wav") for kind in ("src", "ref")]
        for path, sec in zip(paths, (s_sec, r_sec)):
            run_vc.save_wav(path, synth_wav(rng, sec), SR)
        pairs.append({"source": paths[0], "reference": paths[1],
                      "output": os.path.join(work, "out", f"vc{i}.wav")})
    with open(os.path.join(work, "pairs.json"), "w") as f:
        json.dump(pairs, f)
    argv = ["--pairs", os.path.join(work, "pairs.json"), "--conan_dir", dirs[0],
            "--emformer_dir", dirs[1], "--vocoder_dir", dirs[2],
            "--hparams", f"vocoder_denoise_c={DENOISE_C}"]
    logmel.launches = 0
    t0 = time.perf_counter()
    try:
        run_vc.main(argv)
    except SystemExit as e:
        fail(f"run_vc exited {e.code}")
    wall = time.perf_counter() - t0
    launches = logmel.launches
    errs = []
    for pair in pairs:
        want = eng.infer_once(load_wav(pair["source"], SR), load_wav(pair["reference"], SR),
                              use_scan=True, bucket_lengths=True)[0]
        want = np.clip(run_vc.postprocess(want, eng.cfg.mel, DENOISE_C, eng.device), -1, 1)
        got = load_wav(pair["output"], SR) * (32768 / 32767)
        if got.shape != want.shape:
            fail(f"run_vc wrote {got.shape} samples, the engine gives {want.shape}")
        errs.append(float(np.abs(got - want).max()))
    if max(errs) > 1.01 / 32767:
        fail(f"run_vc's wavs differ from the engine's output by {errs} (int16 step "
             f"{1 / 32767:.3g})")
    wav = synth_wav(rng, 4.0)
    card = run_vc.postprocess(wav, eng.cfg.mel, DENOISE_C, eng.device)
    cpu = run_vc.postprocess(wav, eng.cfg.mel, DENOISE_C, "cpu")
    den_err = float(np.abs(card - cpu).max())
    if den_err > DENOISE_ATOL:
        fail(f"denoise on the card {den_err:.3g} from the CPU's (atol {DENOISE_ATOL})")
    audio_s = sum(len(load_wav(p["source"], SR)) for p in pairs) / SR
    print(f"run_vc: main on {len(pairs)} pairs (r5 random checkpoints, vocoder_denoise_c "
          f"{DENOISE_C}; each pair one capture, its reference unpadded): exit 0 in {wall:.2f} "
          f"s for {audio_s:.2f} s of source (RTF {wall / audio_s:.4f}, captures included); "
          f"written wavs vs the engine's use_scan output "
          f"after postprocess max abs {max(errs):.3g} (int16 step {1 / 32767:.3g}); logmel "
          f"launches {launches}; denoise (c {DENOISE_C}) of 4 s on the card vs the CPU max abs "
          f"{den_err:.3g} (atol {DENOISE_ATOL})", flush=True)
    return launches


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

    # 4b-4d. the captured loop, the flow configuration, run_vc
    by_path = {"main": launches, "scan": scan_phase(eng, dirs, src, ref)}
    train_kernels = []
    if not trained:
        by_path.update(flow=flow_phase(args.seed, src, ref), run_vc=run_vc_phase(eng, dirs, rng))
        # 5. train, 6. conan_train, 7. emformer_train, 8. postnet_train
        train_kernels = train_phase(args.seed, dev, rng)
        by_path["conan_train"] = conan_train_phase(args.seed, dev)
        by_path["emformer_train"] = emformer_train_phase(args.seed, dev, smi, dirs, src, ref)
        postnet_train_phase(args.seed, dev, smi)

    kernel = {"name": "logmel", "route": "cuda", "source": "conan_tpu_torch/csrc/logmel.cu",
              "replaces": "conan_tpu/ops/pallas_stft.py:52", "launches": launches,
              "launches_by_path": by_path,
              "max_abs_err": err, "max_abs_diff": err, "ms": ms,
              "kernel_device_ms": serve_device_ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}

    # 9. kernels line, 10. result line
    print(json.dumps({"kernels": [kernel, *train_kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
