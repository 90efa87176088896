#!/usr/bin/env python3
"""Smoke run of the PyTorch port (conan_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--trained conan,emf,voc]

Phases, one line each (the train phase several), then a JSON line of kernels
and the result line:

  1. device   the card's name and power limit (nvidia-smi); exits 1 without CUDA
  2. build    every kernel in conan_tpu_torch/csrc (sm_90a), one nvcc a
              source, all started together, then linked
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
  4e. torch_import  the main phase's random weights written as the original
              system's PyTorch state dicts (reference names) and read back
              through torch_compat and params_from_torch onto the card:
              every leaf equal to the native tree's, infer_once on them
              equal to the native engine's (max abs 0)
  5. train    the vocoder GAN train step at production width
              (egs/soak_r5/vocoder.yaml with train_precision: highest set
              over it, i.e. fp32 "exact"): the training kernels (K2 on the
              MSD's 15 grouped geometries, K1's GAN form at its three n_fft)
              against their plain versions in value and gradient; then
              VocoderTask + Trainer.fit for 5 steps at B = 18: loss terms,
              skipped updates, ms per step, peak memory, kernel launches per
              step against the count the code predicts, and a profiled step;
              then the same batch through Trainer.fit at the shipped rung
              (train_precision default: bf16 operands, K2-bf16 on the MSD
              with its hand-written dx and dw, their launches counted; the
              profiled step's cuDNN grouped backward kernels, if any, with
              the groups of their convs); then one step at B = 2 on the card
              against the same step on the CPU in fp32 (losses) and float64
              (gradients), and the "default" and "high" steps against the
              float64 one; then K2 on each grouped geometry beside cuDNN,
              its bound and cuDNN's backward there, K2-bf16 on each against
              its plain version (values, dx, dw) beside cuDNN in bf16, K2-bf16
              dx and dw alone against theirs (relative L2 1e-4) with their
              times (wrapper, device, bare launches) beside cuDNN's bf16
              conv1d_input / conv1d_weight and the bound, the backward per
              default step, and K1's GAN form's times
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
  5b. vocoder_options  (run right after 5) egs/hifigan_shuffle.yaml as
              shipped (train_precision default, B = 18) with the conditional
              MPD and MSD, the spectrogram discriminator, feature matching
              and accumulate_grad_batches 2: K1's GAN form at the
              spectrogram discriminator's 80-bin geometry against its plain
              version (value and dwav); 4 mini-steps (2 updates) through
              Trainer.fit: ms per mini-step, peak memory, K1-GAN and
              K2-bf16 launches against the count the code predicts, a
              profiled mini-step; the B = 2 step with every option on at
              highest against the CPU's (the train check's bound leaf by
              leaf, its witnesses the CPU's fp32 step and the card's
              generic-kernel route; that route in float64 held to the
              CPU's float64); Accumulate.update on a mini-step without an
              update against the running mean alone, timed; one
              non-causal step; the causal "nn" + resblock-2 and the NSF
              generators' apply on one 5.12 s mel
  8b. denseconv  (run right after 8) K3, the "default" rung's dense
              conv1d (stride 1, groups 1), on every geometry the vocoder,
              Conan and postnet default steps above ran through it (each
              recorded at its step's B and T): K3, its dx and dw against
              their plain versions in float64 (relative L2 1e-4) beside the
              parent's route (cuDNN's bf16 convs cast to fp32), the weight
              layouts bit for bit, dw twice the same bits; wrapper, device
              and bare-launch ms, the bound, the plain versions' ms and
              cuDNN's bf16 and fp32 (TF32 off) convs' ms; sums per task.
              The default rows of 5, 5b, 6 and 8 count K3's launches (each
              forward call of a geometry K3 takes launches it once), and 5
              and 6 name the cuDNN dense conv1d kernels left in a step
              profiled with shapes: only geometries K3 does not take
  9. infer    the training CLI's --infer: 4 synthesized test utterances of
              4-6 s binarized by ConanBinarizer (K1), converted by
              train.run.main --infer with the main phase's r5 random-weight
              checkpoints (egs/soak_r5/conan.yaml: the guard on every item):
              items, captures and their ms, wall and RTF per item, the
              manifest's worst stream-vs-offline diff (1e-3), each written
              wav against a direct stream_scan of its mels; then --infer for
              egs/soak_r5/vocoder.yaml on the train phase's work dir
  10. rmvpe  RMVPE (E2E0 at the published geometry) from seeded weights
              written as an rmvpe.pt under the reference's names, loaded by
              RMVPE.from_torch_checkpoint on the card: its salience on a 10 s
              synthesized clip against the CPU's (max abs 1e-4, argmax
              flips), ms at B=1, RTF, peak memory, kernels and the largest
              by torch.profiler; then extract_f0.main over 4 synthesized
              utterances and run_binarize.main (K1): each record's f0 equals
              its written _f0.npy
  11. dist_train  data parallelism on the card: 2 gloo ranks sharing it
              (NCCL takes one rank a device), each a subprocess of this
              script with its own timeout: the vocoder step at production
              width (egs/soak_r5/vocoder.yaml, highest, B = 18 as 9 + 9)
              against the one-rank step on the whole batch (losses rtol
              1e-4 from its fp32 step; gradient leaves from its float64
              step within 1e-3 relative L2, or 4x its fp32 step's worst
              leaf, as the train phase's check); Trainer.fit for
              3 steps on each rank (ms per step beside the one-rank step,
              peak memory per rank, K1-GAN and K2 launches against the
              prediction); ConanTask at the r5 width across the k-means
              hook; the ranks' states bit-identical after each
  12. nccl1   one vocoder step through an NCCL group of one rank equals the
              step with no group, bit for bit
  13. shard   shard_streams with two shards on the card, 4 streams at the
              r5 geometry through the captured loop: codes equal to the
              unsharded captured run, wav within 1e-4; K1 launched on each
              shard; ms per chunk
  14. leftovers  the modules ported last, one line each: the Emformer's
              two-head mode (mode="both") at the r5 geometry, its step
              chunk by chunk against its apply (1e-4, codes equal) and
              against the CPU, ms per step; the flow F0 head's dynamic clip
              in a captured chunk step against the eager one, the bounds
              refilled per chunk and binding; the vocoder micro-harness's
              CLI (bench_vocoder) on the r5 vocoder config as a subprocess:
              p50, RTF, consistency OK; device_trace around one captured
              r5 chunk and the frontend: the trace names the chunk's
              kernels (K1's launches are noted where the profiler records
              them, not required)
  15. {"kernels": [...]}
  16. {"ok": true, "device": {...}}

The weights are random, made from --seed and written as checkpoint dirs
under build/; the audio is synthesized from the seed. --trained names the
stages (conan, emf, voc) that load the trained checkpoints/soak_r5_<stage>/
deploy weights instead; the audio then is two of the r5 validation wavs, and
the run stops after phase 4b (serving, the rungs against exact), its kernels
line holding logmel alone. Imports nothing of JAX or conan_tpu.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import ctypes
import dataclasses
import functools
import datetime
import hashlib
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
import torch.distributed as tdist
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule
from torch.utils._python_dispatch import TorchDispatchMode

from conan_tpu_torch.audio.mel import MelConfig
from conan_tpu_torch.checkpoint import (load_ckpt_state, params_from_jax, save_checkpoint,
                                        tree_leaves, tree_map)
from conan_tpu_torch.config import load_config, set_hparams
from conan_tpu_torch.data.binarizer import ConanBinarizer, load_wav
from conan_tpu_torch.data.record_store import RecordReader
from conan_tpu_torch.infer import run_vc
from conan_tpu_torch.infer.build import build_engine, write_random_checkpoints
from conan_tpu_torch.models.conan.model import Conan, ConanConfig
from conan_tpu_torch.models.emformer import EmformerConfig, EmformerDistillModel
from conan_tpu_torch.models.vocoder.discriminators import DiscriminatorS
from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig, HifiGanGenerator
from conan_tpu_torch.nn.inits import fan_in_redraw
from conan_tpu_torch.ops import conv as conv_ops
from conan_tpu_torch.ops import native, precision
from conan_tpu_torch.ops.denseconv import (_bf16_operand, dense_conv1d_bf16_input_grad_reference,
                                           dense_conv1d_bf16_reference,
                                           dense_conv1d_bf16_weight_grad_reference,
                                           dense_kernel_takes, dense_plan, dense_wgrad_plan,
                                           denseconv, kernel_weights, kernel_weights_dx)
from conan_tpu_torch.ops.groupconv import (bf16_dx_plan, bf16_plan, bf16_wgrad_plan, groupconv,
                                           grouped_conv1d_bf16_input_grad_reference,
                                           grouped_conv1d_bf16_reference,
                                           grouped_conv1d_bf16_weight_grad_reference,
                                           grouped_conv1d_reference, kernel_weights_bf16,
                                           kernel_weights_bf16_dx, sm_count)
from conan_tpu_torch.ops.precision import precision_scope, rounded_dot, training_scope
from conan_tpu_torch.parallel import dist
from conan_tpu_torch.ops.logmel import (GAN_CLIP, GAN_EPS, _gan_vjp, gan_pad, logmel,
                                        logmel_gan, logmel_gan_reference, logmel_reference)
from conan_tpu_torch.train.losses import gan_mel_configs
from conan_tpu_torch.train.run import build_task, build_train_iter, use_random_ref_after
from conan_tpu_torch.train.tasks import ConanTask, VocoderTask
from conan_tpu_torch.train.trainer import Trainer
from conan_tpu_torch.utils.profiling import device_trace, sync

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
# the card's float64 step (plain K1/K2) against the CPU's, leaf by leaf: a
# float64 route carries ~1e-12 of fp32's 2-3e-3 rounding offsets, and a fault
# in the route's code would carry its own size
STEP_F64_REL = 1e-6
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
# operands): values as K2's (fp32 sums in another order); dx and dw through
# its autograd Function against the same convs in fp32 on the rounded
# operands with the incoming gradient rounded (precision.rounded_dot), the
# bound set when cuDNN computed them from bf16 operands and returned bf16:
# one bf16 rounding of each result, at most 2^-9 of an element, about 2^-9 /
# sqrt(3) = 1.1e-3 in relative L2. K2-bf16 dx and dw return fp32; held to
# their plain versions on the same inputs, which sum the same exact bf16
# products in fp32 in another order, they keep BF16_KERNEL_GRAD_REL.
BF16_GRAD_REL = 4e-3
BF16_KERNEL_GRAD_REL = 1e-4
# K3 (the "default" rung's dense conv1d), its dx and dw against their plain
# versions run in float64 on the same rounded operands: relative L2 per
# tensor. The kernels sum the same exact bf16 products in fp32 in another
# order (1e-7 to 3e-5 measured); the parent's route, cuDNN's bf16 convs cast
# to fp32, lands at 1.6e-3 to 6.6e-3: one bf16 rounding of each result.
# DENSE_ITERS calls a timing (after one warm call) and a profiler window.
DENSE_REL = 1e-4
DENSE_ITERS = 5
# The default_rung phase: the rest of the rung's routes (conv2d and
# conv_transpose1d, K3 over their folds or rounded_dot; the dots' fp32-output
# cuBLAS product) held to float64 on the rounded operands, relative L2 per
# tensor: DENSE_REL where the fold runs K3; off K3 ``route_limit`` of the
# sum's length n, ROUTE_REL or, where larger, ROUTE_SUM_HEADROOM times
# sqrt(n)·2^-24, the size of an fp32 sum's rounding over n terms (cuBLAS's
# weight gradient of Conan's FFN, 35,904 rows a sum, lands at 1.0e-5 of
# float64: 0.89 sqrt(n)·2^-24). The parent's route, the op on bf16 tensors
# cast to fp32, lands at 7e-4 to 2.4e-3. The MPD's periods; Conan's mel
# discriminator batch.
ROUTE_REL = 1e-5
ROUTE_SUM_HEADROOM = 2.0
MPD_PERIODS = (2, 3, 5, 7, 11)
CONAN_WINDOW_B = 24


def route_limit(terms: int) -> float:
    """The relative L2 a route off K3 is held to for a sum of ``terms``
    products (ROUTE_REL, ROUTE_SUM_HEADROOM)."""
    return max(ROUTE_REL, ROUTE_SUM_HEADROOM * math.sqrt(terms) * 2.0 ** -24)
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
# step_rows' steps: one warm, RUNG_STEPS timed, one profiled, one under
# bf16_output_ops
STEP_ROWS_STEPS = RUNG_STEPS + 3
RUNG_BOUND = {
    "vocoder": {"default": {"loss": 0.03, "tree": 0.7}, "high": {"loss": 1e-4, "tree": 0.05}},
    "conan": {"default": {"loss": 0.05, "tree": 0.06}, "high": {"loss": 6e-4, "tree": 0.01}},
    "emformer": {"default": {"loss": 3e-4, "tree": 0.1}, "high": {"loss": 5e-5, "tree": 0.02}},
    "postnet": {"default": {"loss": 1e-5, "tree": 0.02}, "high": {"loss": 1e-5, "tree": 3e-3}},
}
# The vocoder_options phase: egs/hifigan_shuffle.yaml as shipped (the
# "default" rung, B = 18 x 8000 samples) with the conditional MPD and MSD,
# the spectrogram discriminator and feature matching on and
# accumulate_grad_batches 2, OPT_MINI_STEPS mini-steps (two updates) through
# Trainer.fit. The non-causal generator there keeps T x 320 samples with
# kernel 11 at rate 5 (the shipped 10 makes T x 320 + 8, which the mel loss
# cannot take, in either package); the NSF generator's source needs whole
# multiples, so it runs at its own rates [8, 8, 2, 2]; each apply on one
# OPT_APPLY_SECONDS mel.
OPT_MINI_STEPS, OPT_APPLY_SECONDS = 4, 5.12
NONCAUSAL_KERNELS = [16, 11, 8, 4]
NSF_RATES = {"upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4]}
# The infer phase: INFER_SPEAKERS x INFER_UTTS synthesized test utterances of
# INFER_FRAMES frames (4-6 s), binarized by ConanBinarizer, converted by the
# training CLI's --infer through the r5 random-weight checkpoints of the main
# phase; each written wav (int16) against a direct stream_scan of its mels
# within one int16 step (1/32767) plus CAPTURED_ATOL.
INFER_SPEAKERS, INFER_UTTS, INFER_FRAMES = 2, 2, (200, 300)
# The postnet_train phase: egs/soak_r5/postnet.yaml as shipped (a 20x256
# DiffNet over the mel, train_precision default) on conan_train's corpus
# and trained work dir, after spec_stats: POST_STEPS steps through the
# training CLI, resumed to POST_RESUMED; its check at the width below.
POST_STEPS, POST_RESUMED = 4, 6
POST_CHECK = {"residual_layers": 2, "residual_channels": 16}
# The rmvpe phase: the card's salience against the CPU's on one
# RMVPE_SECONDS clip, both fp32 with TF32 off (the CPU test holds the port
# to JAX at 2e-5, tests/test_torch_rmvpe.py; cuDNN's convs and GRU sum in
# other orders); the B=1 call timed over RMVPE_ITERS; RMVPE_UTTS utterances
# of INFER_FRAMES frames through extract_f0 and the binarizer.
RMVPE_SECONDS, RMVPE_ATOL, RMVPE_ITERS, RMVPE_UTTS = 10.0, 1e-4, 10, 4
# The dist_train phase: DIST_RANKS gloo ranks on the one card, each a
# subprocess of this script (--dist_rank) that fails the phase past
# DIST_RANK_TIMEOUT_S, every collective past DIST_COLLECTIVE_S. The vocoder at
# production width (B = TRAIN_B as 9 + 9) for one held step and DIST_STEPS
# steps of Trainer.fit; ConanTask at the r5 width on DIST_CONAN_B synthesized
# rows of DIST_CONAN_T frames for DIST_CONAN_STEPS steps with CONAN_GATES, so
# that the k-means hook runs before step 2.
DIST_RANKS, DIST_STEPS, DIST_RANK_TIMEOUT_S, DIST_COLLECTIVE_S = 2, 3, 400, 180
DIST_CONAN_B, DIST_CONAN_T, DIST_CONAN_STEPS = 4, 1024, 4
# The shard phase: SHARD_B streams of SHARD_SECONDS (references half as long)
# over two shards on the card.
SHARD_B, SHARD_SECONDS = 4, 2.56
# leftovers: the two-head Emformer over 64 segments (5.12 s of mel frames);
# the flow's dynamic clip over 8 chunks of the engine's 4 frames; the
# vocoder micro-harness's default 50 chunks; a captured r5 chunk runs ~790
# kernels (the scan line), so a trace of one holds more than 500
LEFTOVER_EMF_SEGS = 64
LEFTOVER_FLOW_SEG, LEFTOVER_FLOW_CHUNKS = 4, 8
LEFTOVER_BENCH_CHUNKS, LEFTOVER_BENCH_TIMEOUT_S = 50, 300
TRACE_MIN_KERNELS = 500
TRACE_FRONTEND_CALLS = 3
# kernel_device_ms: profiler windows taken at most to record a kernel's launches
KERNEL_DEVICE_WINDOWS = 6


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def zero_train_launches() -> None:
    """Sets the training path's launch counts to 0: K1-GAN's, K2's,
    K2-bf16's forward, dx and dw, and K3's forward, dx and dw."""
    logmel_gan.launches = groupconv.launches = groupconv.launches_bf16 = 0
    groupconv.launches_bf16_dx = groupconv.launches_bf16_dw = 0
    denseconv.launches = denseconv.launches_dx = denseconv.launches_dw = 0


def train_launches() -> dict:
    """The training path's launch counts, by the kernels line's names."""
    return {"logmel_gan": logmel_gan.launches, "groupconv": groupconv.launches,
            "groupconv_bf16": groupconv.launches_bf16,
            "groupconv_bf16_dx": groupconv.launches_bf16_dx,
            "groupconv_bf16_dw": groupconv.launches_bf16_dw,
            "denseconv": denseconv.launches, "denseconv_dx": denseconv.launches_dx,
            "denseconv_dw": denseconv.launches_dw}


K3_NAMES = ("denseconv", "denseconv_dx", "denseconv_dw")


@dataclasses.dataclass
class DenseRecord:
    """What the "default" runs record for the denseconv and default_rung
    phases and the kernels line: ``geoms`` geometry (B, T, Ci, Co, K,
    stride, dilation, pad_l, pad_r) → {task: dense conv1d calls a step},
    ``launches`` path → K3's launches there ({name: count}) over
    ``steps[path]`` steps, ``predicted[path]`` the forward launches its
    recorded conv1d calls predict, ``dots`` (einsum spec or "matmul", a's
    shape, b's shape) → {task: dot calls a step}."""
    geoms: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    dots: dict = dataclasses.field(default_factory=dict)
    steps: dict = dataclasses.field(default_factory=dict)
    predicted: dict = dataclasses.field(default_factory=dict)

    def add(self, task: str, seen, steps: int) -> None:
        """The calls ``recording_convs`` counted over ``steps`` steps."""
        for g, n in seen.items():
            self.geoms.setdefault(g, {})[task] = n // steps

    def add_dots(self, task: str, seen, steps: int) -> None:
        """The calls ``recording_dots`` counted over ``steps`` steps."""
        for g, n in seen.items():
            self.dots.setdefault(g, {})[task] = n // steps


@contextlib.contextmanager
def recording_convs():
    """Counts every dense conv1d call through the port's ops.conv.conv1d,
    and under "default" the conv1d each ops.conv.conv2d and
    conv_transpose1d call folds onto (Conv2dFold, ConvTranspose1dFold),
    inside the block by geometry (B, T, Ci, Co, K, stride, dilation, pad_l,
    pad_r), into the yielded Counter (the modules that imported them by
    name too); grouped calls are not counted."""
    seen = collections.Counter()
    orig = {"conv1d": conv_ops.conv1d, "conv2d": conv_ops.conv2d,
            "conv_transpose1d": conv_ops.conv_transpose1d}

    def rec1d(x, w, b=None, *, stride=1, dilation=1, padding=(0, 0), groups=1):
        if groups == 1:
            seen[(*x.shape, w.shape[0], w.shape[2], stride, dilation, *padding)] += 1
        return orig["conv1d"](x, w, b, stride=stride, dilation=dilation, padding=padding,
                              groups=groups)

    def rec2d(x, w, b=None, *, stride=1, padding=0):
        if precision.bf16_dots():
            f = conv_ops.conv2d_fold(tuple(x.shape), tuple(w.shape), conv_ops._pair(stride),
                                     conv_ops._pair(padding))
            ci, co, k, d = f.geometry
            seen[(f.B, f.U * f.Wo, ci, co, k, 1, d, 0, 0)] += 1
        return orig["conv2d"](x, w, b, stride=stride, padding=padding)

    def rec_t(x, w, b=None, *, stride, padding=0, output_padding=0):
        if precision.bf16_dots():
            f = conv_ops.conv_transpose1d_fold(tuple(x.shape), tuple(w.shape), stride, padding,
                                               output_padding)
            ci, co, k, d = f.geometry
            seen[(f.B, f.T, ci, co, k, 1, d, *f.padding)] += 1
        return orig["conv_transpose1d"](x, w, b, stride=stride, padding=padding,
                                        output_padding=output_padding)

    rec = {"conv1d": rec1d, "conv2d": rec2d, "conv_transpose1d": rec_t}
    patched = [(m, name) for mod_name, m in sys.modules.items()
               if mod_name.startswith("conan_tpu_torch") for name in orig
               if getattr(m, name, None) is orig[name]]
    for m, name in patched:
        setattr(m, name, rec[name])
    try:
        yield seen
    finally:
        for m, name in patched:
            setattr(m, name, orig[name])


class _Bf16Outputs(TorchDispatchMode):
    """Counts every product or conv aten op (``PRODUCT_OP``) whose output is
    a bf16 tensor."""

    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if PRODUCT_OP.search(func._schema.name.split("::")[-1]) and any(
                isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
                for t in (out if isinstance(out, (tuple, list)) else (out,))):
            self.seen[str(func)] += 1
        return out


# the aten ops that multiply (mm, bmm, addmm, matmul, linear, einsum, dot,
# mv, every convolution and its backward), by their base name
PRODUCT_OP = re.compile(r"mm|mv|dot|conv|linear|einsum|matmul")
# a cuBLAS / cuDNN kernel whose name shows bf16 operands and a bf16 output
# (``..._bf16bf16_bf16f32_f32_...``: operands, output and compute types)
BF16_OUTPUT_KERNEL = re.compile(r"bf16bf16_bf16")


@contextlib.contextmanager
def bf16_output_ops():
    """Counts, into the yielded Counter, the product and conv aten ops run
    inside the block (their backward too) that return a bf16 tensor: a dot
    or conv whose result is rounded to bf16 shows here by name. The
    "default" rung must leave it empty."""
    seen = collections.Counter()
    with _Bf16Outputs(seen):
        yield seen


def bf16_output_kernels(kernels) -> list[str]:
    """The names among profiled CUDA kernels (key_averages entries) that show
    a bf16 output (``BF16_OUTPUT_KERNEL``), with their counts."""
    return [f"{e.key[:90]} x{e.count}" for e in kernels if BF16_OUTPUT_KERNEL.search(e.key)]


@contextlib.contextmanager
def recording_dots():
    """Counts every ``dot_at_rung`` and ``einsum_at_rung`` call of the port's
    modules (those that imported them by name; not the card route's own
    inner calls) inside the block by (einsum spec or "matmul", a's shape,
    b's shape), into the yielded Counter."""
    seen = collections.Counter()
    dot, einsum = precision.dot_at_rung, precision.einsum_at_rung

    def rec_dot(a, b):
        seen[("matmul", tuple(a.shape), tuple(b.shape))] += 1
        return dot(a, b)

    def rec_einsum(spec, a, b):
        seen[(spec, tuple(a.shape), tuple(b.shape))] += 1
        return einsum(spec, a, b)

    patched = [(m, name, orig) for mod_name, m in sys.modules.items()
               if mod_name.startswith("conan_tpu_torch") and m is not precision
               for name, orig in (("dot_at_rung", dot), ("einsum_at_rung", einsum))
               if getattr(m, name, None) is orig]
    for m, name, _ in patched:
        setattr(m, name, rec_dot if name == "dot_at_rung" else rec_einsum)
    try:
        yield seen
    finally:
        for m, name, orig in patched:
            setattr(m, name, orig)


def k3_takes(g: tuple) -> bool:
    """Whether the route sends geometry ``g`` (recording_convs') to K3."""
    B, T, Ci, Co, K, s, d, pl, pr = g
    return s == 1 and dense_kernel_takes(Ci, Co, K, d)


def k3_forward_pred(seen) -> int:
    """K3's forward launches the recorded calls make: one a call K3 takes."""
    return sum(n for g, n in seen.items() if k3_takes(g))


def conv_kernels(prof) -> dict:
    """{(op, input shape, weight shape, (stride, dilation, transposed,
    groups) as text, "?" where the trace lacks them): {kernel name: [count,
    device ms]}} for the CUDA kernels under each aten::convolution and
    aten::convolution_backward of a trace with shapes."""
    out: dict = collections.defaultdict(dict)
    for evt in prof.events():
        for k in evt.kernels:
            op = evt
            while op is not None and op.name not in ("aten::convolution",
                                                     "aten::convolution_backward"):
                op = op.cpu_parent
            if op is None or len(op.input_shapes) < 3:
                continue
            shapes = [tuple(s) for s in op.input_shapes[:3]]
            x, w = (shapes[0], shapes[1]) if op.name == "aten::convolution" else shapes[1:3]
            # stride, dilation, transposed, groups from the op's scalar
            # arguments where the trace has them
            at = (3, 5, 6, 8) if op.name == "aten::convolution" else (4, 6, 7, 9)
            args = list(getattr(op, "concrete_inputs", None) or [])
            conf = tuple(str(args[i]) if i < len(args) else "?" for i in at)
            row = out[(op.name, x, w, conf)].setdefault(k.name, [0, 0.0])
            row[0] += 1
            row[1] += k.duration / 1e3
    return out


def dense_cudnn_left(prof) -> tuple[list[str], list[str]]:
    """The kernels a trace with shapes ran under a 1-D convolution (3-D
    input), by geometry, as (those of geometries K3 takes, the rest), each
    "Ci->Co k=K: n kernels, ms (names)": the first must be empty under
    "default". A transposed or grouped conv, or one of another stride,
    counts with the rest."""
    found: dict = {}
    for (op, x, w, (stride, dil, transposed, groups)), kernels in conv_kernels(prof).items():
        if len(x) != 3 or len(w) != 3:
            continue
        d = int(re.sub(r"\D", "", dil) or 1)
        takes = (x[1] == w[1] and transposed != "True" and groups in ("1", "?")
                 and re.sub(r"\D", "", stride) in ("1", "") and dense_kernel_takes(
                     w[1], w[0], w[2], d))
        row = found.setdefault((takes, f"{w[1]}->{w[0]} k={w[2]}"), [0, 0.0, set()])
        for name, (count, ms) in kernels.items():
            row[0] += count
            row[1] += ms
            row[2].add(re.sub(r"^void |<.*|\(.*", "", name).split("::")[-1][:48])
    text = {True: [], False: []}
    for (takes, geom), (count, ms, names) in sorted(found.items()):
        text[takes].append(f"{geom}: {count} kernels, {ms:.3f} ms ({', '.join(sorted(names))})")
    return text[True], text[False]


def denseconv_bound_ms(B: int, T: int, ci: int, t_out: int, co: int,
                       k: int) -> tuple[float, str]:
    """Least time for one dense conv at the "default" rung, and for its dx
    and its dw (the same products and bytes): the larger of its fp32 input,
    weights and output once over HBM and its FLOPs as bf16 products at the
    dense bf16 peak. Returns (ms, "bytes" or "operations")."""
    t_bytes = 4 * (B * T * ci + co * ci * k + B * t_out * co) / PEAK_HBM_BYTES
    t_ops = 2 * B * t_out * co * ci * k / PEAK_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


def kernel_device_ms(fn, key: str, iters: int = 20) -> float | None:
    """Device time of one launch of the kernel whose name holds ``key``
    (``fn`` launches it once), by torch.profiler after a warm call: the mean
    over the launches the profiler recorded. Beside ``cuda_ms``, which times
    the whole wrapper call (its other launches and, for a kernel of a few
    µs, the host), this is the kernel alone. Each window is the profiler's
    warm-up pass over ``iters`` calls, its records dropped, then an active
    pass over ``iters`` calls. The profiler misses launches now and then
    (whole runs recorded none, or 8, of K1-GAN's 20 three windows running),
    so windows are taken, KERNEL_DEVICE_WINDOWS at most, until they have
    recorded ``iters`` launches between them, each window's count printed
    when there is more than one. The profiler also records a launch too
    many now and then (a window of 5 calls recorded 6 launches of one
    kernel whose wrapper launches it once a call): such a window is
    dropped, its count printed with a star. Where the windows kept record
    fewer than ``iters // 2`` between them, the kernel's device time is not
    measured in this run: None, with a note. It fails where ``key`` names
    more than one kernel among the records."""
    fn()
    torch.cuda.synchronize()
    device_us, recorded, counts = 0.0, 0, []
    for _ in range(KERNEL_DEVICE_WINDOWS):
        active = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: active.append(
                         [e for e in p.key_averages()
                          if e.device_type == DeviceType.CUDA and key in e.key])) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        if len(active) != 1:
            fail(f"kernel_device_ms: the profiler's schedule gave {len(active)} active passes")
        if len(active[0]) > 1:
            fail(f"kernel_device_ms: {key} names {len(active[0])} kernels: "
                 + "; ".join(e.key[:80] for e in active[0]))
        count = sum(e.count for e in active[0])
        if count > iters:
            counts.append(f"{count}*")
            continue
        counts.append(count)
        device_us += sum(e.self_device_time_total for e in active[0])
        recorded += count
        if recorded >= iters:
            break
    if len(counts) > 1:
        dropped = any(isinstance(c, str) for c in counts)
        print(f"kernel_device_ms: {key}: windows of {iters} calls recorded "
              f"[{', '.join(map(str, counts))}] launches"
              + (" (* more than the calls: dropped)" if dropped else ""), flush=True)
    if recorded < iters // 2:
        print(f"kernel_device_ms: {key}: device time not measured ({recorded} launches "
              f"recorded in the kept windows of {iters} calls, {len(counts)} taken)", flush=True)
        return None
    return device_us / 1e3 / recorded


def total(values) -> float | None:
    """The sum of ``values``, or None where one of them is None (a device
    time not measured)."""
    values = list(values)
    return None if any(v is None for v in values) else sum(values)


def ms_text(ms: float | None) -> str:
    """``ms`` as printed beside a kernel's wrapper time."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


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
              f"T={t}: kernel {row['ms']:.4f} ms (device {ms_text(row['kernel_device_ms'])}), "
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


def groupconv_bf16_launch_ms(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int,
                             groups: int, lib=None, tiles=None,
                             iters: int = 50) -> tuple[float, torch.Tensor, torch.Tensor]:
    """K2-bf16's conv kernel alone, by CUDA events, where the profiler may
    miss launches: the C entry point ``groupconv_bf16_conv`` launched
    ``iters`` times back to back after a warm-up, on weights laid out
    (``groupconv_bf16_weights``) and tensor maps encoded
    (``groupconv_bf16_describe``) once. ``lib`` and ``tiles`` default to
    the shipped library and plan. Returns (ms a launch, y, the weights'
    layout)."""
    lib = lib or native.load()
    B, T, Ci = x.shape
    Co, cig, K = w.shape
    T_out = (T + 2 * pad - K) // stride + 1
    plan = bf16_plan(B, T_out, Ci, Co, groups, K, stride, tiles)
    wq = torch.empty(Co, K * (-(-cig // 16) * 16), dtype=torch.bfloat16, device=x.device)
    y = torch.full((B, T_out, Co), float("nan"), device=x.device)
    maps = ctypes.create_string_buffer(256)
    stream = torch.cuda.current_stream().cuda_stream
    geometry = (B, T, Ci, T_out, Co, groups, K, stride, pad)
    err = (lib.groupconv_bf16_weights(w.data_ptr(), wq.data_ptr(), Co, cig, K, stream)
           or lib.groupconv_bf16_describe(x.data_ptr(), wq.data_ptr(), B, T, Ci, Co, groups, K,
                                          plan.bn, ctypes.addressof(maps)))

    def launch():
        if lib.groupconv_bf16_conv(ctypes.addressof(maps), y.data_ptr(), *geometry, *plan.args,
                                   stream):
            fail(f"groupconv_bf16_conv refused {geometry} with {plan}")

    if err:
        fail(f"groupconv_bf16 weights or tensor maps: cudaError {err} for {geometry}")
    return cuda_ms(launch, iters=iters), y, wq


def groupconv_bf16_dx_launch_ms(gy: torch.Tensor, w: torch.Tensor, x_shape, stride: int,
                                pad: int, groups: int, lib=None,
                                iters: int = 50) -> tuple[float, torch.Tensor, torch.Tensor]:
    """K2-bf16 dx's conv alone, by CUDA events, as groupconv_bf16_launch_ms
    times the forward's: ``groupconv_bf16_dx_conv`` launched ``iters`` times
    back to back on weights laid out (``groupconv_bf16_dx_weights``) and
    tensor maps encoded once. Returns (ms a launch, dx, the weights'
    layout)."""
    lib = lib or native.load()
    B, T, Ci = x_shape
    T_out, Co = gy.shape[1], gy.shape[2]
    K = w.shape[2]
    geo, plan = bf16_dx_plan(B, T, Ci, T_out, Co, groups, K, stride, pad)
    wq = torch.empty(stride * Ci, geo.kp * (-(-(Co // groups) // 16) * 16), dtype=torch.bfloat16,
                     device=gy.device)
    dx = torch.full((B, T, Ci), float("nan"), device=gy.device)
    maps = ctypes.create_string_buffer(256)
    stream = torch.cuda.current_stream().cuda_stream
    geometry = (B, T, Ci, T_out, Co, groups, K, stride, pad)
    err = (lib.groupconv_bf16_dx_weights(w.data_ptr(), wq.data_ptr(), Ci, Co, groups, K, stride,
                                         stream)
           or lib.groupconv_bf16_describe(gy.data_ptr(), wq.data_ptr(), B, T_out, Co,
                                          stride * Ci, groups, geo.kp, plan.bn,
                                          ctypes.addressof(maps)))

    def launch():
        if lib.groupconv_bf16_dx_conv(ctypes.addressof(maps), dx.data_ptr(), *geometry,
                                      *plan.args, stream):
            fail(f"groupconv_bf16_dx_conv refused {geometry} with {plan}")

    if err:
        fail(f"groupconv_bf16 dx weights or tensor maps: cudaError {err} for {geometry}")
    return cuda_ms(launch, iters=iters), dx, wq


def groupconv_bf16_dw_launch_ms(x: torch.Tensor, gy: torch.Tensor, w_shape, stride: int,
                                pad: int, groups: int, lib=None, plan=None,
                                iters: int = 50) -> tuple[float, torch.Tensor]:
    """K2-bf16 dw alone (its one launch), by CUDA events: the C entry point
    ``groupconv_weight_grad_bf16`` called ``iters`` times back to back, a
    split plan's workspace and zeroed counters allocated once (the kernel
    leaves the counters zeroed). ``lib`` and ``plan`` default to the
    shipped library and the plan the wrapper takes on this card. Returns
    (ms a call, dw)."""
    lib = lib or native.load()
    B, T, Ci = x.shape
    T_out, Co = gy.shape[1], gy.shape[2]
    plan = plan or bf16_wgrad_plan(B, T_out, Ci, Co, groups, w_shape[2], stride,
                                   sm_count(x.device.index))
    dw = torch.full(tuple(w_shape), float("nan"), device=x.device)
    ws = torch.empty(max(plan.ws_floats, 4), device=x.device)
    counters = torch.zeros(2 * plan.n_tiles, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    geometry = (B, T, Ci, T_out, Co, groups, w_shape[2], stride, pad)

    def launch():
        if lib.groupconv_weight_grad_bf16(x.data_ptr(), gy.data_ptr(), ws.data_ptr(),
                                          counters.data_ptr(), dw.data_ptr(), *geometry,
                                          *plan.args, stream):
            fail(f"groupconv_weight_grad_bf16 refused {geometry} with {plan}")

    return cuda_ms(launch, iters=iters), dw


def groupconv_bf16_grad_row(name: str, x: torch.Tensor, w: torch.Tensor, gy: torch.Tensor,
                            stride: int, pad: int, groups: int) -> dict:
    """K2-bf16 dx and dw on one geometry, each against its plain version
    (relative L2 within BF16_KERNEL_GRAD_REL, max abs beside it), through
    the wrapper and as bare launches (dx's weight layout against
    kernel_weights_bf16_dx, bit for bit), then timed: bare launches and
    wrapper calls by CUDA events, the kernels' device time by the profiler
    (dx: its conv; dw: its one kernel), the plain versions and cuDNN's bf16
    conv1d_input / conv1d_weight (bf16 tensors, the yardstick only)."""
    conv = dict(stride=stride, padding=(pad, pad), groups=groups)
    row = {}
    with torch.no_grad():
        grads = {"dx": (lambda: groupconv.input_grad_bf16(gy, w, x.shape, **conv),
                        lambda: grouped_conv1d_bf16_input_grad_reference(gy, w, x.shape,
                                                                        **conv)),
                 "dw": (lambda: groupconv.weight_grad_bf16(x, gy, w.shape, **conv),
                        lambda: grouped_conv1d_bf16_weight_grad_reference(x, gy, w.shape,
                                                                         **conv))}
        bare = {}
        row["dx_launch_ms"], bare["dx"], wq = groupconv_bf16_dx_launch_ms(gy, w, x.shape, stride,
                                                                          pad, groups)
        row["dw_launch_ms"], bare["dw"] = groupconv_bf16_dw_launch_ms(x, gy, w.shape, stride,
                                                                      pad, groups)
        if not torch.equal(wq, kernel_weights_bf16_dx(w, groups, stride)):
            fail(f"{name}: dx's weight layout differs from kernel_weights_bf16_dx")
        for which, (kernel_fn, plain_fn) in grads.items():
            got, want = kernel_fn(), plain_fn()
            torch.cuda.synchronize()
            if not torch.equal(got, kernel_fn()):
                fail(f"{name} {which}: two calls on the same inputs differ")
            for label, g_ in (("wrapper", got), ("bare launches", bare[which])):
                err = rel_l2(g_, want)
                if not err <= BF16_KERNEL_GRAD_REL:
                    fail(f"{name} {which} ({label}): relative L2 {err:.3g} from the plain "
                         f"version (limit {BF16_KERNEL_GRAD_REL})")
            row[f"{which}_kernel_rel_l2"] = rel_l2(got, want)
            row[f"{which}_max_abs_err"] = float((got - want).abs().max())
            row[f"{which}_ms"] = cuda_ms(kernel_fn, iters=20)
            row[f"{which}_plain_ms"] = cuda_ms(plain_fn, iters=10)
        row["dx_kernel_device_ms"] = kernel_device_ms(grads["dx"][0], "groupconv_bf16_kernel")
        row["dw_kernel_device_ms"] = kernel_device_ms(grads["dw"][0], "k2bf16_wgrad_kernel")
        xp = F.pad(x.transpose(1, 2), (pad, pad)).bfloat16()
        gy_b, w_b = gy.transpose(1, 2).bfloat16(), w.bfloat16()
        row["dx_library_ms"] = cuda_ms(lambda: torch.nn.grad.conv1d_input(
            xp.shape, w_b, gy_b, stride=stride, groups=groups), iters=10)
        row["dw_library_ms"] = cuda_ms(lambda: torch.nn.grad.conv1d_weight(
            xp, w.shape, gy_b, stride=stride, groups=groups), iters=10)
    return row


def groupconv_bf16_phase(geoms: list[tuple], gen: torch.Generator, dev: torch.device
                         ) -> tuple[list[dict], float, float]:
    """K2-bf16 under the "default" rung on each grouped geometry at B =
    TRAIN_B: the value against its plain version (max abs, relative L2), dx
    and dw through its autograd Function against rounded_dot's (relative
    L2), the kernel's weight layout against its plain version (bit for
    bit), then its time (the wrapper call; the kernel by the profiler and by
    bare launches) beside the plain version, cuDNN's F.conv1d on bf16
    tensors and the bound; K2-bf16 dx and dw alone (groupconv_bf16_grad_row,
    the bound theirs too: the same bytes and products); and the backward's
    time at this rung through the autograd Function (K2-bf16 dx + dw as in
    the discriminator step, dx alone as in the generator step). Returns the
    rows, the max abs value error and the worst gradient relative L2."""
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
            row["launch_ms"], y_bare, wq = groupconv_bf16_launch_ms(x, w, s, pd, g)
            if not torch.equal(wq, kernel_weights_bf16(w)):
                fail(f"{name}: the kernel's weight layout differs from kernel_weights_bf16")
            compare(f"{name} (bare launches)", y_bare, want, LOGMEL_ATOL, LOGMEL_RTOL)
            row.update(
                ms=cuda_ms(lambda: groupconv(x, w, **k2)),
                kernel_device_ms=kernel_device_ms(lambda: groupconv(x, w, **k2),
                                                  "groupconv_bf16_kernel"),
                plain_ms=cuda_ms(lambda: grouped_conv1d_bf16_reference(x, w, **k2)),
                library_ms=cuda_ms(lambda: F.conv1d(x_cf, w_b, stride=s, padding=pd,
                                                    groups=g)))
        row.update(groupconv_bf16_grad_row(
            name, x, w, torch.randn(got.shape, generator=gen).to(dev), s, pd, g))
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        with training_scope("default", dev):
            y_both, y_dx = groupconv(xg, wg, **k2), groupconv(xg, w, **k2)
            gy = torch.randn_like(y_both)
            row["bwd_dx_dw_ms"] = cuda_ms(
                lambda: torch.autograd.grad(y_both, (xg, wg), gy, retain_graph=True), iters=20)
            row["bwd_dx_ms"] = cuda_ms(
                lambda: torch.autograd.grad(y_dx, xg, gy, retain_graph=True), iters=20)
        row["bound_ms"], row["bound_by"] = groupconv_bf16_bound_ms(TRAIN_B, t, ci, co, k, s,
                                                                   g, pd)
        rows.append(row)
        print(f"train groupconv_bf16 geometry: scale {scale} {ci}->{co} s{s} g{g} B={TRAIN_B} "
              f"T={t}: vs plain max abs {float((got - want).abs().max()):.3g}, rel L2 "
              f"{row['rel_l2']:.3g}, dx {row['dx_rel_l2']:.3g}, dw {row['dw_rel_l2']:.3g}; "
              f"kernel {row['ms']:.4f} ms (device {ms_text(row['kernel_device_ms'])}, bare "
              f"launches {row['launch_ms']:.4f} ms), cuDNN bf16 F.conv1d "
              f"{row['library_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4g} ms by {row['bound_by']}; "
              + "; ".join(
                  f"K2-bf16 {k} vs plain rel L2 {row[k + '_kernel_rel_l2']:.3g} (max abs "
                  f"{row[k + '_max_abs_err']:.3g}), kernel {row[k + '_ms']:.4f} ms (device "
                  f"{ms_text(row[k + '_kernel_device_ms'])}, bare launches "
                  f"{row[k + '_launch_ms']:.4f} ms), cuDNN bf16 {row[k + '_library_ms']:.4f} "
                  f"ms, plain {row[k + '_plain_ms']:.4f} ms, bound {row['bound_ms']:.4g} ms"
                  for k in ("dx", "dw"))
              + f"; backward (K2-bf16 dx and dw) dx+dw {row['bwd_dx_dw_ms']:.4f} ms, dx "
              f"{row['bwd_dx_ms']:.4f} ms", flush=True)
    return rows, err, grad_err


def cudnn_grouped_backward(prof) -> list[tuple]:
    """The cuDNN kernels in a torch.profiler trace (``record_shapes``)
    whose names say grouped dgrad or wgrad, one (name, groups, shapes) a
    launch: the groups of the conv whose backward launched it (input
    channels over the weight's second dimension, None where the trace does
    not say) and its grad, input and weight shapes. cuDNN also names
    kernels of dense convs so (one channel in or out)."""
    found = []
    for evt in prof.events():
        for k in evt.kernels:
            if "grouped" not in k.name or not ("dgrad" in k.name or "wgrad" in k.name) \
                    or "k2bf16" in k.name:
                continue
            op = evt
            while op is not None and op.name != "aten::convolution_backward":
                op = op.cpu_parent
            shapes = list(op.input_shapes[:3]) if op is not None else []
            groups = (shapes[1][1] // shapes[2][1]
                      if len(shapes) == 3 and len(shapes[1]) > 1 and len(shapes[2]) > 1
                      and shapes[2][1] else None)
            found.append((k.name.split("<")[0][-40:], groups, shapes))
    return found


def step_rows(task, state, batch, step_kw: dict, gen=None) -> dict:
    """RUNG_STEPS steps of ``task`` on ``batch`` from ``state`` after one
    warm step: ms per step by CUDA events and the peak memory; then one step
    under torch.profiler: wall and device ms, kernels, the largest, those
    named with a bf16 output; one more under bf16_output_ops (a "default"
    step fails on any product with a bf16 result); the last timed step's
    losses."""
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
    with bf16_output_ops() as bf16_ops:
        task.train_step(state, batch, gen, **step_kw)
        torch.cuda.synchronize()
    if task.precision == "default" and bf16_ops:
        fail(f"default steps: products with a bf16 result: {dict(bf16_ops)}")
    return {"ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])], "peak_gb": peak_gb,
            "bf16_out": f"{sum(bf16_ops.values())} aten products; kernels: "
                        f"{'; '.join(bf16_output_kernels(kernels)) or 'none'}",
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
            f"{r['largest']}; with a bf16 result (one more step, under bf16_output_ops; the "
            f"profiled step's kernel names): {r['bf16_out']}; losses: {r['losses']}")


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


def generic_card_step(task, state0: dict, small: dict):
    """The same step on the card through generic kernels: ATen's own CUDA
    convolutions (cuDNN off) and the plain versions of K1 and K2 in place
    of the kernels, so it shares no kernel under test with the task's own
    route. It runs in the dtype of ``state0`` and ``small`` (float64 too)."""
    from conan_tpu_torch.ops import conv as conv_ops
    from conan_tpu_torch.train import losses as losses_mod
    from conan_tpu_torch.train import tasks as tasks_mod

    saved = conv_ops.groupconv, losses_mod.logmel_gan, tasks_mod.logmel_gan
    conv_ops.groupconv = grouped_conv1d_reference
    losses_mod.logmel_gan = tasks_mod.logmel_gan = logmel_gan_reference
    try:
        with torch.backends.cudnn.flags(enabled=False):
            return task.train_step(state0, small)
    finally:
        conv_ops.groupconv, losses_mod.logmel_gan, tasks_mod.logmel_gan = saved


def vocoder_step_check(phase: str, hp, task, state0: dict, small: dict,
                       generic_witness: bool = False):
    """One VocoderTask step on the card against the same step on the CPU
    (plain versions, oneDNN off), from ``state0`` and ``small`` with no
    generator: loss terms to the CPU's fp32 step at STEP_RTOL, every gradient
    leaf (the optimizers' first moments after a first step, (1 - b1) times
    the clipped gradient) to its float64 step. Without ``generic_witness``
    the limit is max(STEP_GRAD_REL, STEP_FP32_FACTOR x the CPU fp32 step's
    worst leaf). With it, each leaf has its own limit, max(STEP_GRAD_REL,
    STEP_FP32_FACTOR x the worse of that leaf's CPU fp32 and card
    generic-kernel errors): ``generic_card_step`` is a second fp32 route that
    shares no kernel under test, and on some batches every fp32 route on the
    card (cuDNN, ATen's convs, im2col products) lands 2-3e-3 from float64 on
    the conditional MPD's input-side leaves (its first layer, the mel
    upsampler) where the CPU's lands 5e-5 (PERF.md §7); a leaf where no
    witness shows such an offset keeps 1e-3. The same generic route in
    float64 on the card is held to the CPU's float64 step at STEP_F64_REL,
    leaf by leaf: it tells an fp32 rounding offset of the card's route from a
    fault in it. Prints the phase's check line; returns the float64 step's
    (state, metrics)."""
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
        fail(f"{phase}: card step losses {m_gpu} != CPU step losses {m_cpu} (rtol {STEP_RTOL})")
    # the optimizer's first moment after a first step is (1 - b1) · the clipped
    # gradient, leaf by leaf; both fp32 steps against the float64 one
    with torch.backends.mkldnn.flags(enabled=False):
        new_64, m_64 = task_cpu.train_step(
            tree_map(lambda t: t.cpu().double() if t.is_floating_point() else t.cpu(),
                     state0), {k: v.cpu().double() for k, v in small.items()})
    steps = [("card", new_gpu), ("cpu", new_cpu), ("f64", new_64)]
    if generic_witness:
        steps.append(("generic", generic_card_step(task, state0, small)[0]))
        steps.append(("card_f64", generic_card_step(
            task, tree_map(lambda t: t.double() if t.is_floating_point() else t, state0),
            {k: v.double() for k, v in small.items()})[0]))
    mu = {name: {opt: tree_leaves(st[opt]["mu"]) for opt in ("opt_g", "opt_d")}
          for name, st in steps}
    errs = {name: {opt: [rel_l2(a.cpu(), b) for a, b in zip(mu[name][opt], mu["f64"][opt])]
                   for opt in ("opt_g", "opt_d")} for name in mu if name != "f64"}
    worst = {name: {opt: max(range(len(e)), key=e.__getitem__) for opt, e in errs[name].items()}
             for name in errs}
    cpu_worst = max(max(e) for e in errs["cpu"].values())
    if generic_witness:
        limits = {opt: [max(STEP_GRAD_REL, STEP_FP32_FACTOR * max(errs["cpu"][opt][i],
                                                                 errs["generic"][opt][i]))
                        for i in range(len(errs["card"][opt]))] for opt in ("opt_g", "opt_d")}
    else:
        limits = {opt: [max(STEP_GRAD_REL, STEP_FP32_FACTOR * cpu_worst)] * len(es)
                  for opt, es in errs["card"].items()}
    past = [f"{opt} leaf {i} {tuple(mu['f64'][opt][i].shape)} {e:.3g} (limit "
            f"{limits[opt][i]:.3g})"
            for opt, es in errs["card"].items() for i, e in enumerate(es) if e > limits[opt][i]]
    if past:
        fail(f"{phase}: card gradient leaves off the CPU's float64 step past their limits (the "
             f"CPU's fp32 step's worst leaf {cpu_worst:.3g}): {'; '.join(past)}")
    widened = sorted(((opt, i, lim) for opt, ls in limits.items() for i, lim in enumerate(ls)
                      if lim > STEP_GRAD_REL), key=lambda t: -t[2])
    f64_note = ""
    if "card_f64" in errs:
        f64_worst = {opt: max(errs["card_f64"][opt]) for opt in ("opt_g", "opt_d")}
        if max(f64_worst.values()) > STEP_F64_REL:
            fail(f"{phase}: the card's float64 step (plain K1/K2) off the CPU's past "
                 f"{STEP_F64_REL}: G {f64_worst['opt_g']:.3g}, D {f64_worst['opt_d']:.3g}")
        f64_note = (f"; the card's float64 step (generic kernels) against the CPU's: G "
                    f"{f64_worst['opt_g']:.3g}, D {f64_worst['opt_d']:.3g} (limit "
                    f"{STEP_F64_REL})")
    print(f"{phase} check: one step at B={CHECK_B} on the card ({t_gpu:.2f} s) against the same "
          f"step on the CPU with device='cpu' ({t_cpu:.2f} s, plain versions, oneDNN off): "
          f"loss terms max rel diff {loss_err:.3g} (rtol {STEP_RTOL}); gradient leaves from the "
          f"CPU's float64 step, max rel L2 over {len(errs['card']['opt_g'])} G + "
          f"{len(errs['card']['opt_d'])} D leaves: card G "
          + ", D ".join(f"{errs['card'][o][worst['card'][o]]:.3g} (leaf {worst['card'][o]})"
                        for o in ("opt_g", "opt_d"))
          + ", CPU fp32 G "
          + ", D ".join(f"{errs['cpu'][o][worst['cpu'][o]]:.3g} (leaf {worst['cpu'][o]})"
                        for o in ("opt_g", "opt_d"))
          + ("" if not generic_witness else ", card generic kernels G " + ", D ".join(
              f"{errs['generic'][o][worst['generic'][o]]:.3g} (leaf {worst['generic'][o]})"
              for o in ("opt_g", "opt_d")))
          + (f"; limit max({STEP_GRAD_REL}, {STEP_FP32_FACTOR} x the CPU fp32 step's worst) "
             f"{limits['opt_g'][0]:.3g}" if not generic_witness else
             f"; limit per leaf max({STEP_GRAD_REL}, {STEP_FP32_FACTOR} x that leaf's worse "
             f"witness), past {STEP_GRAD_REL} on {len(widened)} leaves"
             + "".join(f"{', ' if j else ': '}{opt} leaf {i} {lim:.3g} (card "
                       f"{errs['card'][opt][i]:.3g})"
                       for j, (opt, i, lim) in enumerate(widened[:6])))
          + f64_note, flush=True)
    return new_64, m_64


def train_phase(seed: int, dev: torch.device, rng: np.random.Generator,
                dense: DenseRecord) -> list[dict]:
    """Phase 5: the vocoder GAN train step at production width (the default
    run's dense conv1d calls and K3 launches into ``dense``). Returns the
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
    zero_train_launches()
    with recording_convs() as seen, recording_dots() as dots:
        state_default = Trainer(task_default, hp_shipped, work_default).fit(default_batches())
    torch.cuda.synchronize()
    dense.add("vocoder", seen, n_default)
    dense.add_dots("vocoder", dots, n_default)
    dense.steps["train"] = n_default
    k3 = dense.launches["train"] = {k: train_launches()[k] for k in K3_NAMES}
    k3_pred = dense.predicted["train"] = k3_forward_pred(seen)
    if k3["denseconv"] != k3_pred or not k3["denseconv_dx"] or not k3["denseconv_dw"]:
        fail(f"train_precision {shipped}: K3 launches {k3} in {n_default} steps; predicted "
             f"{k3_pred} forward launches (one a dense conv1d call it takes), dx and dw some")
    k2_bf16_launches, k2_default_tf32 = groupconv.launches_bf16, groupconv.launches
    dx_launches, dw_launches = groupconv.launches_bf16_dx, groupconv.launches_bf16_dw
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
    # K2-bf16's backward: dx on every grouped layer of the generator step's
    # MSD pass (y_hat; the discriminator's weights take no gradient there)
    # and of the discriminator step's two (y and y_hat), dw on those two
    dx_pred, dw_pred = 3 * len(geoms), 2 * len(geoms)
    if (dx_launches, dw_launches) != (dx_pred * n_default, dw_pred * n_default):
        fail(f"train_precision {shipped}: launches per step groupconv_bf16 dx "
             f"{dx_launches / n_default}, dw {dw_launches / n_default}; predicted {dx_pred}, "
             f"{dw_pred}")
    if sum(r["skipped"] for r in records_d) or not all(
            np.isfinite(v) for r in records_d for v in r.values() if isinstance(v, float)):
        fail(f"train_precision {shipped}: skipped updates or non-finite metrics {records_d}")
    # one profiled step without shapes (its wall and busy share, comparable
    # across runs), then one recording shapes (host work on every op), read
    # only for which convs cuDNN's grouped dgrad/wgrad kernels served
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task_default.train_step(state_default, batch)
        torch.cuda.synchronize()
        default_wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels_d = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    default_device_ms = sum(e.self_device_time_total for e in kernels_d) / 1e3
    # the forward's and dx's convs are one kernel template (dx runs it on the
    # phases side by side, with its own epilogue)
    bf16_evs = [e for e in kernels_d if "groupconv_bf16_kernel" in e.key]
    dw_evs = [e for e in kernels_d if "k2bf16_wgrad" in e.key]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof_shapes:
        task_default.train_step(state_default, batch)
        torch.cuda.synchronize()
    cudnn_grouped = cudnn_grouped_backward(prof_shapes)
    dense_k3, dense_rest = dense_cudnn_left(prof_shapes)
    if dense_k3:
        fail(f"train_precision {shipped}: cuDNN served dense conv1d geometries K3 takes: "
             f"{dense_k3}")
    with bf16_output_ops() as bf16_ops:
        task_default.train_step(state_default, batch)
        torch.cuda.synchronize()
    bf16_kernels = bf16_output_kernels(kernels_d)
    if bf16_ops:
        fail(f"train_precision {shipped}: products with a bf16 result: {dict(bf16_ops)}")
    if sum(e.count for e in bf16_evs) != k2_pred + dx_pred \
            or any(groups != 1 for _name, groups, _shapes in cudnn_grouped):
        fail(f"train_precision {shipped}: the profiled step ran groupconv_bf16_kernel "
             f"{sum(e.count for e in bf16_evs)} times, k2bf16_wgrad_kernel "
             f"{sum(e.count for e in dw_evs)}, predicted {k2_pred} + {dx_pred}, {dw_pred}; "
             f"cuDNN's grouped dgrad/wgrad kernels (name, the conv's groups, shapes) "
             f"{cudnn_grouped}")
    grouped_by = {}
    for name, groups, shapes in cudnn_grouped:
        key = f"{name} for a conv of groups {groups}, grad/input/weight {shapes}"
        grouped_by[key] = grouped_by.get(key, 0) + 1
    top_d = sorted(kernels_d, key=lambda e: -e.self_device_time_total)[:6]
    print(f"train {shipped}: the same batch through Trainer.fit at the shipped "
          f"train_precision {shipped!r} (bf16 operands and fp32 results for every dot and "
          f"conv, K2-bf16 on the MSD), {n_default} steps: ms per step "
          f"{[round(x, 3) for x in default_ms]}, median "
          f"after 1 warmup step {np.median(default_ms[1:]):.3f} (highest's "
          f"{np.median(step_ms[1:]):.3f}); peak memory {default_peak_gb:.3f} GB; launches per "
          f"step groupconv_bf16 {k2_bf16_launches / n_default:g}, its dx "
          f"{dx_launches / n_default:g} (predicted {dx_pred}) and dw "
          f"{dw_launches / n_default:g} (predicted {dw_pred}), groupconv (3xTF32) "
          f"{k2_default_tf32 / n_default:g}, logmel_gan {k1_default / n_default:g}; "
          f"one profiled step (shapes not recorded): wall {default_wall_ms:.3f} ms, device kernels "
          f"{default_device_ms:.3f} ms (busy {100 * default_device_ms / default_wall_ms:.1f}%), "
          f"{sum(e.count for e in kernels_d)} kernels, K2-bf16 forward and dx convs "
          f"x{sum(e.count for e in bf16_evs)} "
          f"{sum(e.self_device_time_total for e in bf16_evs) / 1e3:.3f} ms, dw's kernel "
          f"x{sum(e.count for e in dw_evs)} "
          f"{sum(e.self_device_time_total for e in dw_evs) / 1e3:.3f} ms; in a second step "
          f"recording shapes, cuDNN kernels named grouped dgrad or wgrad {len(cudnn_grouped)}, "
          f"none for a grouped conv: "
          f"{'; '.join(f'{k} x{n}' for k, n in grouped_by.items()) or 'none'}; K3 launches "
          f"per step {k3['denseconv'] / n_default:g} (predicted {k3_pred / n_default:g}), dx "
          f"{k3['denseconv_dx'] / n_default:g}, dw {k3['denseconv_dw'] / n_default:g}; cuDNN "
          f"kernels under a dense conv1d in the step recording shapes, none for a geometry K3 "
          f"takes: {'; '.join(dense_rest) or 'none'}; products with a bf16 result in one more "
          f"step (bf16_output_ops) {sum(bf16_ops.values())}, kernels named with a bf16 output in "
          f"the profiled step: {'; '.join(bf16_kernels) or 'none'}; largest: "
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
    new_64, m_64 = vocoder_step_check("train", hp, task, state0, small)
    both_mu = lambda st: tree_leaves(st["opt_g"]["mu"]) + tree_leaves(st["opt_d"]["mu"])  # noqa: E731
    print("train rungs: " + rung_check(
        "vocoder", lambda rung: VocoderTask(dict(hp, train_precision=rung)), state0, small, m_64,
        both_mu(new_64), both_mu), flush=True)

    # the kernels' times at the step's shapes
    k2_rows = groupconv_times(geoms, gen, dev)
    k2_sum = {key: total(r[key] for r in k2_rows)
              for key in ("ms", "kernel_device_ms", "plain_ms", "library_ms", "bound_ms",
                          "bwd_dx_dw_ms", "bwd_dx_ms")}
    k2_by = {by: sum(r["bound_ms"] for r in k2_rows if r["bound_by"] == by)
             for by in ("bytes", "operations")}
    print(f"train groupconv sums over the {len(geoms)} geometries: kernel {k2_sum['ms']:.4f} "
          f"ms (device {ms_text(k2_sum['kernel_device_ms'])}), cuDNN {k2_sum['library_ms']:.4f} "
          f"ms, plain {k2_sum['plain_ms']:.4f} ms, bound "
          f"{k2_sum['bound_ms']:.4g} ms; backward dx+dw {k2_sum['bwd_dx_dw_ms']:.4f} ms, dx "
          f"{k2_sum['bwd_dx_ms']:.4f} ms, so per step (2 MSD passes with dx+dw in the "
          f"discriminator step, 1 with dx in the generator step) forward "
          f"{3 * k2_sum['ms']:.4f} ms, backward "
          f"{2 * k2_sum['bwd_dx_dw_ms'] + k2_sum['bwd_dx_ms']:.4f} ms", flush=True)
    bf16_rows, bf16_err, bf16_grad_err = groupconv_bf16_phase(geoms, gen, dev)
    grad_keys = [f"{k}_{key}" for k in ("dx", "dw")
                 for key in ("ms", "kernel_device_ms", "launch_ms", "plain_ms", "library_ms")]
    bf16_sum = {key: total(r[key] for r in bf16_rows)
                for key in ("ms", "kernel_device_ms", "launch_ms", "plain_ms", "library_ms",
                            "bound_ms", "bwd_dx_dw_ms", "bwd_dx_ms", *grad_keys)}
    grad_err = {k: (max(r[f"{k}_kernel_rel_l2"] for r in bf16_rows),
                    max(r[f"{k}_max_abs_err"] for r in bf16_rows)) for k in ("dx", "dw")}
    bf16_by = {by: sum(r["bound_ms"] for r in bf16_rows if r["bound_by"] == by)
               for by in ("bytes", "operations")}
    print(f"train groupconv_bf16 sums over the {len(geoms)} geometries: values max abs "
          f"{bf16_err:.3g} (atol {LOGMEL_ATOL}, rtol {LOGMEL_RTOL}), max rel L2 "
          f"{max(r['rel_l2'] for r in bf16_rows):.3g}; dx/dw max rel L2 {bf16_grad_err:.3g} "
          f"(limit {BF16_GRAD_REL}); kernel {bf16_sum['ms']:.4f} ms (device "
          f"{ms_text(bf16_sum['kernel_device_ms'])}, bare launches "
          f"{bf16_sum['launch_ms']:.4f} ms), cuDNN bf16 {bf16_sum['library_ms']:.4f} "
          f"ms, plain {bf16_sum['plain_ms']:.4f} ms, bound {bf16_sum['bound_ms']:.4g} ms "
          f"(3xTF32 K2 {k2_sum['ms']:.4f} ms, device {ms_text(k2_sum['kernel_device_ms'])}); "
          + "; ".join(
              f"K2-bf16 {k}: max rel L2 {grad_err[k][0]:.3g} (limit {BF16_KERNEL_GRAD_REL}), "
              f"max abs {grad_err[k][1]:.3g}, kernel {bf16_sum[k + '_ms']:.4f} ms (device "
              f"{ms_text(bf16_sum[k + '_kernel_device_ms'])}, bare launches "
              f"{bf16_sum[k + '_launch_ms']:.4f} ms), cuDNN bf16 "
              f"{bf16_sum[k + '_library_ms']:.4f} ms, plain {bf16_sum[k + '_plain_ms']:.4f} ms, "
              f"bound {bf16_sum['bound_ms']:.4g} ms" for k in ("dx", "dw"))
          + f"; backward (K2-bf16 dx and dw) dx+dw {bf16_sum['bwd_dx_dw_ms']:.4f} ms, dx "
          f"{bf16_sum['bwd_dx_ms']:.4f} ms, so per default step (2 MSD passes with dx+dw in "
          f"the discriminator step, 1 with dx in the generator step) forward "
          f"{3 * bf16_sum['ms']:.4f} ms, backward "
          f"{2 * bf16_sum['bwd_dx_dw_ms'] + bf16_sum['bwd_dx_ms']:.4f} ms (through cuDNN, PR "
          f"16: 79.9-105.2 ms)", flush=True)
    with torch.no_grad():
        k1_ms = k1_plain_ms = k1_library_ms = k1_bound_ms = 0.0
        k1_device = []
        k1_bound = {"bytes": 0.0, "operations": 0.0}
        for cfg in gan_cfgs:
            window = torch.hann_window(cfg.win_length, periodic=True, device=dev)
            melw = logmel_gan.dense_constants(cfg, dev)[1]
            k1_ms += cuda_ms(lambda: logmel_gan(wavs, cfg))
            k1_device.append(kernel_device_ms(lambda: logmel_gan(wavs, cfg),
                                              "logmel_fft_kernel"))
            k1_plain_ms += cuda_ms(lambda: logmel_gan_reference(wavs, cfg))
            k1_library_ms += cuda_ms(lambda: library_logmel_gan(wavs, cfg, window, melw))
            b_ms, b_by = logmel_bound_ms(TRAIN_B, T, T // cfg.hop, cfg, melw)
            k1_bound_ms += b_ms
            k1_bound[b_by] += b_ms
    k1_device_ms = total(k1_device)
    print(f"train kernel times: logmel_gan over its {len(gan_cfgs)} resolutions on "
          f"B={TRAIN_B} x {T}: kernel {k1_ms:.4f} ms (device {ms_text(k1_device_ms)}), plain "
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
         "launch_ms": bf16_sum["launch_ms"], "bwd_dx_dw_ms": bf16_sum["bwd_dx_dw_ms"],
         "bwd_dx_ms": bf16_sum["bwd_dx_ms"], "geometries": len(geoms),
         "scale1_layer": {key: bf16_rows[0][key] for key in
                          ("ms", "kernel_device_ms", "launch_ms", "plain_ms", "library_ms",
                           "bound_ms")}},
        *({"name": f"groupconv_bf16_{k}", "route": "cuda", "source": source,
           "replaces": "conan_tpu/ops/pallas_groupconv.py:151",
           "replaces_note": "no Pallas kernel: the XLA VJP of the Pallas forward's custom_vjp",
           "launches": launches, "max_abs_err": grad_err[k][1], "max_abs_diff": grad_err[k][1],
           "rel_l2": grad_err[k][0], "ms": bf16_sum[f"{k}_ms"],
           "kernel_device_ms": bf16_sum[f"{k}_kernel_device_ms"],
           "launch_ms": bf16_sum[f"{k}_launch_ms"], "plain_ms": bf16_sum[f"{k}_plain_ms"],
           "bound_ms": bf16_sum["bound_ms"], "bound_by": max(bf16_by, key=bf16_by.get),
           "library_ms": bf16_sum[f"{k}_library_ms"], "geometries": len(geoms),
           "scale1_layer": {key: bf16_rows[0][f"{k}_{key}"] for key in
                            ("ms", "kernel_device_ms", "launch_ms", "plain_ms", "library_ms")}
           | {"bound_ms": bf16_rows[0]["bound_ms"]}}
          for k, launches, source in (
              ("dx", dx_launches, "conan_tpu_torch/csrc/groupconv.cu"),
              ("dw", dw_launches, "conan_tpu_torch/csrc/groupconv_bwd.cu"))),
    ]


def conan_corpus(hp, rng: np.random.Generator, speakers: int = CONAN_SPEAKERS,
                 utts: int = CONAN_UTTS, frames: tuple = CONAN_FRAMES,
                 prefix: str = "spk") -> None:
    """Write a corpus for the ConanBinarizer where ``hp`` says (the
    conan_train phase's by default): ``speakers`` x ``utts`` utterances
    named ``<prefix><speaker>_<utt>`` of ``frames`` frames, each one's wav,
    its F0 contour per frame as ``<wav dir>_f0/<name>_f0.npy``, random
    content codes 0-99 in ``metadata.json``, and the speaker map."""
    from scipy.io import wavfile

    hop = hp["hop_size"]
    wav_dir = os.path.join(hp["processed_data_dir"], "wavs")
    os.makedirs(wav_dir)
    os.makedirs(wav_dir + "_f0")
    items = []
    for spk in range(speakers):
        for utt in range(utts):
            name = f"{prefix}{spk}_{utt}"
            n = int(rng.integers(frames[0], frames[1] + 1))
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
        json.dump({f"{prefix}{i}": i for i in range(speakers)}, f)


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


def conan_train_phase(seed: int, dev: torch.device, dense: DenseRecord) -> int:
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
    task_d = ConanTask(dict(hp, train_precision=shipped))
    zero_train_launches()
    with recording_convs() as seen, recording_dots() as dots:
        rows = step_rows(task_d, state, batch, {"use_random_ref": True}, gen)
    dense.add("conan", seen, STEP_ROWS_STEPS)
    dense.add_dots("conan", dots, STEP_ROWS_STEPS)
    dense.steps["conan_train"] = STEP_ROWS_STEPS
    k3 = dense.launches["conan_train"] = {k: train_launches()[k] for k in K3_NAMES}
    k3_pred = dense.predicted["conan_train"] = k3_forward_pred(seen)
    if k3["denseconv"] != k3_pred or not k3["denseconv_dx"] or not k3["denseconv_dw"]:
        fail(f"conan_train {shipped}: K3 launches {k3} in {STEP_ROWS_STEPS} steps; predicted "
             f"{k3_pred} forward launches (one a dense conv1d call it takes), dx and dw some")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof_shapes:
        task_d.train_step(state, batch, gen, use_random_ref=True)
        torch.cuda.synchronize()
    dense_k3, dense_rest = dense_cudnn_left(prof_shapes)
    if dense_k3:
        fail(f"conan_train {shipped}: cuDNN served dense conv1d geometries K3 takes: "
             f"{dense_k3}")
    print(f"conan_train {shipped}: the last batch at the shipped rung (bf16 operands for every "
          f"dot and conv; the dense conv1d through K3, fp32 out) from the trained state, "
          + step_rows_text(shipped, rows, float(np.median(last_phase)))
          + f"; K3 launches a step {k3['denseconv'] / (STEP_ROWS_STEPS):g} (predicted "
          f"{k3_pred / (STEP_ROWS_STEPS):g}), dx {k3['denseconv_dx'] / (STEP_ROWS_STEPS):g}, dw "
          f"{k3['denseconv_dw'] / (STEP_ROWS_STEPS):g}; cuDNN kernels under a dense conv1d in a "
          f"step recording shapes, none for a geometry K3 takes: "
          f"{'; '.join(dense_rest) or 'none'}", flush=True)
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
                         ref: np.ndarray, dense: DenseRecord) -> int:
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
    with recording_dots() as dots:
        rows = step_rows(build_task(dict(hp, train_precision=shipped))[0], state, packed[0], {},
                         gen)
    dense.add_dots("emformer", dots, STEP_ROWS_STEPS)
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


def postnet_train_phase(seed: int, dev: torch.device, smi: str, dense: DenseRecord) -> None:
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
    zero_train_launches()
    with recording_convs() as seen, recording_dots() as dots:
        rows = step_rows(task, params_from_jax(ckpt["state"], dev), batch, {},
                         torch.Generator(device=dev).manual_seed(seed))
    dense.add("postnet", seen, STEP_ROWS_STEPS)
    dense.add_dots("postnet", dots, STEP_ROWS_STEPS)
    dense.steps["postnet_train"] = STEP_ROWS_STEPS
    k3 = dense.launches["postnet_train"] = {k: train_launches()[k] for k in K3_NAMES}
    k3_pred = dense.predicted["postnet_train"] = k3_forward_pred(seen)
    if k3["denseconv"] != k3_pred or not k3["denseconv_dx"] or not k3["denseconv_dw"]:
        fail(f"postnet_train: K3 launches {k3} in {STEP_ROWS_STEPS} steps; predicted {k3_pred} "
             f"forward launches (one a dense conv1d call it takes), dx and dw some")
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
          + step_rows_text(task.precision, rows)
          + f"; K3 launches a step {k3['denseconv'] / (STEP_ROWS_STEPS):g} (predicted "
          f"{k3_pred / (STEP_ROWS_STEPS):g}), dx {k3['denseconv_dx'] / (STEP_ROWS_STEPS):g}, dw "
          f"{k3['denseconv_dw'] / (STEP_ROWS_STEPS):g}", flush=True)
    postnet_step_check(task.hp, batch, seed)


def denseconv_row(g: tuple, calls: dict, gen: torch.Generator, dev: torch.device) -> dict:
    """K3, its dx and its dw on geometry ``g`` (recording_convs'): seeded x,
    w (fan-in uniform), bias and incoming gradient; each result against its
    plain version run in float64 on the same operands (relative L2 within
    DENSE_REL, max abs beside it) and beside the parent's route, cuDNN's
    convs on bf16 tensors cast to fp32; the weight layouts against
    kernel_weights / kernel_weights_dx bit for bit, the bare launches'
    results against the wrapper's, dw twice the same bits; then the times:
    the wrapper call (on the rounded operands), the kernel by the profiler
    (kernel_device_ms), the kernel's C entry alone on laid-out weights and
    encoded maps (bare), the plain versions (fp32), cuDNN's F.conv1d /
    conv1d_input / conv1d_weight on bf16 tensors and in fp32 (TF32 off),
    by CUDA events; and the bound. ``calls``: the geometry's calls a step
    by task, printed."""
    B, T, Ci, Co, K, _s, d, pl, pr = g
    T_out = T + pl + pr - d * (K - 1)
    x = torch.randn(B, T, Ci, generator=gen).to(dev)
    w = ((torch.rand(Co, Ci, K, generator=gen) * 2 - 1) * (3 / (Ci * K)) ** 0.5).to(dev)
    b = (0.1 * torch.randn(Co, generator=gen)).to(dev)
    gy = torch.randn(B, T_out, Co, generator=gen).to(dev)
    conv = dict(dilation=d, padding=(pl, pr))
    name = f"denseconv B={B} T={T} {Ci}->{Co} k={K} d={d} pad=({pl},{pr})"
    lib = native.load()
    stream = torch.cuda.current_stream().cuda_stream
    row = {"geometry": list(g)}
    with torch.no_grad():
        xb, gyb = _bf16_operand(x, "x"), _bf16_operand(gy, "gy")
        wrappers = {"fwd": lambda: denseconv.launch(xb, w, b, **conv),
                    "dx": lambda: denseconv.input_grad(gyb, w, x.shape, **conv),
                    "dw": lambda: denseconv.weight_grad(xb, gyb, w.shape, **conv)}
        plains = {"fwd": lambda t=torch.float32: dense_conv1d_bf16_reference(
                      x.to(t), w.to(t), b.to(t), **conv),
                  "dx": lambda t=torch.float32: dense_conv1d_bf16_input_grad_reference(
                      gy.to(t), w.to(t), x.shape, **conv),
                  "dw": lambda t=torch.float32: dense_conv1d_bf16_weight_grad_reference(
                      x.to(t), gy.to(t), w.shape, **conv)}
        xp = F.pad(x.transpose(1, 2), (pl, pr)).contiguous()
        gyt = gy.transpose(1, 2).contiguous()
        libs = {}
        for dtype in (torch.bfloat16, torch.float32):
            xd, gd, wd = xp.to(dtype), gyt.to(dtype), w.to(dtype)
            libs[dtype] = {
                "fwd": lambda xd=xd, wd=wd: F.conv1d(xd, wd, dilation=d),
                "dx": lambda xd=xd, gd=gd, wd=wd: torch.nn.grad.conv1d_input(
                    xd.shape, wd, gd, dilation=d),
                "dw": lambda xd=xd, gd=gd: torch.nn.grad.conv1d_weight(xd, w.shape, gd,
                                                                       dilation=d)}
        parent = {"fwd": lambda: (libs[torch.bfloat16]["fwd"]().float() + b[:, None]
                                  ).transpose(1, 2),
                  "dx": lambda: libs[torch.bfloat16]["dx"]().float()[:, :, pl:pl + T
                                                                      ].transpose(1, 2),
                  "dw": lambda: libs[torch.bfloat16]["dw"]().float()}
        got = {k: fn() for k, fn in wrappers.items()}
        torch.cuda.synchronize()
        if not torch.equal(got["dw"], wrappers["dw"]()):
            fail(f"{name} dw: two calls on the same inputs differ")
        for k in ("fwd", "dx", "dw"):
            want = plains[k](torch.float64)
            row[f"{k}_rel_l2"] = rel_l2(got[k].double(), want)
            row[f"{k}_max_abs_err"] = float((got[k].double() - want).abs().max())
            row[f"{k}_parent_rel_l2"] = rel_l2(parent[k]().double(), want)
            if not row[f"{k}_rel_l2"] <= DENSE_REL:
                fail(f"{name} {k}: relative L2 {row[f'{k}_rel_l2']:.3g} from the plain version "
                     f"in float64 (limit {DENSE_REL})")
        # the bare launches: weights laid out and maps encoded once
        bare = {}
        sms = sm_count(dev.index or 0)
        for k, (src, w_layout, N, C, T_in, T_o, pad, flip) in {
                "fwd": (xb, kernel_weights(w), Co, Ci, T, T_out, pl, 0),
                "dx": (gyb, kernel_weights_dx(w), Ci, Co, T_out, T, d * (K - 1) - pl, 1)
        }.items():
            plan = dense_plan(C, N, K, d, B * -(-T_o // 64), sms)
            wq = torch.empty_like(w_layout)
            maps = ctypes.create_string_buffer(256)
            out = torch.full((B, T_o, N), float("nan"), device=dev)
            err = (lib.denseconv_weights(w.data_ptr(), wq.data_ptr(), N, C, K, flip, stream)
                   or lib.denseconv_describe(src.data_ptr(), wq.data_ptr(), B, T_in, C, N, K,
                                             plan.bn, plan.win_rows, ctypes.addressof(maps)))
            if err or not torch.equal(wq, w_layout):
                fail(f"{name} {k}: the weights' layout (cudaError {err}) differs from "
                     f"kernel_weights{'_dx' if flip else ''}")
            args = (ctypes.addressof(maps), None if flip else b.data_ptr(), out.data_ptr(), B,
                    T_o, C, N, K, d, pad, *plan.args, stream)
            # the closure holds the maps' buffer and the weights' layout: args
            # holds only their addresses
            bare[k] = (lambda args=args, maps=maps, wq=wq: lib.denseconv_run(*args), out)
        wplan = dense_wgrad_plan(B, T_out, Ci, Co, K, d, sms)
        ws = torch.empty(wplan.ws_floats, device=dev)
        counters = torch.zeros(max(1, 2 * wplan.n_tiles), dtype=torch.int32, device=dev)
        dw_bare = torch.full((Co, Ci, K), float("nan"), device=dev)
        dw_args = (xb.data_ptr(), gyb.data_ptr(), ws.data_ptr() if wplan.ws_floats else None,
                   counters.data_ptr(), dw_bare.data_ptr(), B, T, Ci, T_out, Co, K, d, pl,
                   *wplan.args, stream)
        bare["dw"] = (lambda ws=ws, counters=counters: lib.denseconv_weight_grad(*dw_args),
                      dw_bare)
        for k, (fn, out) in bare.items():
            if fn():
                fail(f"{name} {k}: the C entry refused the plan")
            torch.cuda.synchronize()
            if not torch.equal(out, got[k]):
                fail(f"{name} {k}: the bare launch's result differs from the wrapper's")
            row[f"{k}_launch_ms"] = cuda_ms(fn, iters=DENSE_ITERS, warmup=1)
            row[f"{k}_ms"] = cuda_ms(wrappers[k], iters=DENSE_ITERS, warmup=1)
            row[f"{k}_plain_ms"] = cuda_ms(plains[k], iters=DENSE_ITERS, warmup=1)
            row[f"{k}_library_ms"] = cuda_ms(libs[torch.bfloat16][k], iters=DENSE_ITERS,
                                             warmup=1)
            row[f"{k}_library_fp32_ms"] = cuda_ms(libs[torch.float32][k], iters=DENSE_ITERS,
                                                  warmup=1)
        for k, key in (("fwd", "denseconv_kernel"), ("dx", "denseconv_kernel"),
                       ("dw", "denseconv_wgrad_kernel")):
            row[f"{k}_kernel_device_ms"] = kernel_device_ms(wrappers[k], key, iters=DENSE_ITERS)
    row["bound_ms"], row["bound_by"] = denseconv_bound_ms(B, T, Ci, T_out, Co, K)
    print(f"denseconv geometry: B={B} T={T} {Ci}->{Co} k={K} dilation {d} pad ({pl}, {pr}), "
          f"calls a step {calls}: "
          + "; ".join(
              f"{k} vs plain (float64) rel L2 {row[k + '_rel_l2']:.3g} (max abs "
              f"{row[k + '_max_abs_err']:.3g}; cuDNN bf16 cast to fp32 "
              f"{row[k + '_parent_rel_l2']:.3g}), kernel {row[k + '_ms']:.4f} ms (device "
              f"{ms_text(row[k + '_kernel_device_ms'])}, bare {row[k + '_launch_ms']:.4f} ms), "
              f"plain {row[k + '_plain_ms']:.4f} ms, cuDNN bf16 {row[k + '_library_ms']:.4f} "
              f"ms, fp32 {row[k + '_library_fp32_ms']:.4f} ms" for k in ("fwd", "dx", "dw"))
          + f"; bound {row['bound_ms']:.4g} ms by {row['bound_by']}", flush=True)
    return row


DENSE_KEYS = [f"{k}_{key}" for k in ("fwd", "dx", "dw")
              for key in ("ms", "kernel_device_ms", "launch_ms", "plain_ms", "library_ms",
                          "library_fp32_ms")]


def denseconv_phase(seed: int, dev: torch.device,
                    dense: DenseRecord) -> tuple[list[dict], list[tuple]]:
    """Phase 8b: K3, its dx and dw on every geometry the default steps of
    the train, conan_train and postnet_train phases sent to K3
    (``dense.geoms``), at the step's own B and T (denseconv_row); the
    geometries they sent to rounded_dot are listed. Prints the sums per
    task (one call a geometry, and weighted by the calls of a step).
    Returns the rows and the geometries K3 took."""
    gen = torch.Generator().manual_seed(seed + 18)
    geoms = sorted(g for g in dense.geoms if k3_takes(g))
    others = sorted(g for g in dense.geoms if not k3_takes(g))
    t0 = time.perf_counter()
    rows = [denseconv_row(g, dense.geoms[g], gen, dev) for g in geoms]
    for task in sorted({t for g in geoms for t in dense.geoms[g]}):
        mine = [(r, dense.geoms[g][task]) for r, g in zip(rows, geoms)
                if task in dense.geoms[g]]
        sums = {key: total(r[key] for r, _ in mine) for key in DENSE_KEYS + ["bound_ms"]}
        per_step = {key: total(r[key] * n if r[key] is not None else None for r, n in mine)
                    for key in ("fwd_ms", "fwd_library_ms", "dx_library_ms", "dw_library_ms")}
        print(f"denseconv sums, {task}: {len(mine)} geometries "
              f"({sum(n for _, n in mine)} forward calls a step), one call each: "
              + "; ".join(f"{k} kernel {sums[k + '_ms']:.4f} ms (device "
                          f"{ms_text(sums[k + '_kernel_device_ms'])}, bare "
                          f"{sums[k + '_launch_ms']:.4f}), plain {sums[k + '_plain_ms']:.4f}, "
                          f"cuDNN bf16 {sums[k + '_library_ms']:.4f}, fp32 "
                          f"{sums[k + '_library_fp32_ms']:.4f}" for k in ("fwd", "dx", "dw"))
              + f"; bound {sums['bound_ms']:.4g} ms a kernel; weighted by a step's calls: "
              f"K3 forward {per_step['fwd_ms']:.4f} ms, cuDNN bf16 forward "
              f"{per_step['fwd_library_ms']:.4f}, dx {per_step['dx_library_ms']:.4f}, dw "
              f"{per_step['dw_library_ms']:.4f}", flush=True)
    print(f"denseconv: {len(geoms)} geometries through K3 in {time.perf_counter() - t0:.1f} s, "
          f"worst relative L2 from float64 fwd {max(r['fwd_rel_l2'] for r in rows):.3g}, dx "
          f"{max(r['dx_rel_l2'] for r in rows):.3g}, dw {max(r['dw_rel_l2'] for r in rows):.3g} "
          f"(limit {DENSE_REL}; the parent's cuDNN bf16 route "
          f"{min(r[k + '_parent_rel_l2'] for r in rows for k in ('fwd', 'dx', 'dw')):.3g} to "
          f"{max(r[k + '_parent_rel_l2'] for r in rows for k in ('fwd', 'dx', 'dw')):.3g}); "
          f"through rounded_dot (fp32 on rounded operands: no K3 for one channel in or out): "
          + "; ".join(f"B={g[0]} T={g[1]} {g[2]}->{g[3]} k={g[4]} ({dense.geoms[g]})"
                      for g in others), flush=True)
    return rows, geoms


def product_operands(spec: str, a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The operands of the one product the card's route multiplies for
    ``spec`` (an einsum_at_rung spec, or "matmul" for dot_at_rung): the
    einsum's permuted copies, a 3-D a against a 2-D b flattened."""
    if spec != "matmul":
        a, b, _ = precision._bmm_operands(spec, a, b)
    return (a.reshape(-1, a.shape[-1]), b) if b.dim() == 2 and a.dim() != 2 else (a, b)


def device_ms_of(fn, iters: int = DENSE_ITERS) -> tuple[float | None, float | None]:
    """(device ms, kernels) a call of ``fn``: every kernel the call runs, by
    torch.profiler over windows of ``iters`` calls after a warm one, from
    the first two windows that record the same nonzero count of kernels
    (their mean), at most KERNEL_DEVICE_WINDOWS windows: the profiler drops
    launches now and then, whole windows too. (None, None) where no two
    agree."""
    fn()
    torch.cuda.synchronize()
    seen = {}
    for _ in range(KERNEL_DEVICE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        n = sum(e.count for e in evs)
        ms = sum(e.self_device_time_total for e in evs) / 1e3 / iters
        if n and n in seen:
            return (ms + seen[n]) / 2, n / iters
        seen[n] = ms
    return None, None


def rung_row(family: str, name: str, route_fn, plain_fn, add_bias, ops: list, terms: dict,
             bare, dev: torch.device) -> dict:
    """One geometry of a family the "default" rung folds or multiplies:
    ``route_fn(*ops)`` under the rung (the port's route) with its gradients
    for a seeded incoming gradient, against the float64 ``plain_fn`` (the
    library op, no bias) on the rounded operands (``add_bias`` adds the
    third operand, the bias, whose gradient takes the unrounded incoming
    one) and beside the parent's route, ``plain_fn`` on bf16 tensors cast to
    fp32; relative L2 per tensor within DENSE_REL on K3, else within
    ``route_limit`` of the length of its sums (``terms``: y, dx, dw, db →
    products a sum). Times, forward and backward a call: the route (CUDA events),
    its kernels by the profiler (device), ``bare`` (K3's or cuBLAS's calls
    on operands already folded and rounded), ``plain_fn`` on bf16 tensors
    and in fp32 (TF32 off)."""
    gen = torch.Generator(device=dev).manual_seed(len(name) + sum(map(ord, name)))
    leaves = [t.clone().requires_grad_(True) for t in ops]
    before = denseconv.launches
    with training_scope("default", dev):
        y = route_fn(*leaves)
    k3 = denseconv.launches > before
    gy = torch.randn(y.shape, generator=gen, device=dev)
    got = [y.detach(), *torch.autograd.grad(y, leaves, gy)]
    r64 = [(t.to(torch.bfloat16) if i < 2 else t).double().requires_grad_(True)
           for i, t in enumerate(ops)]
    y64 = plain_fn(*r64[:2])
    y64b = add_bias(y64, r64[2]) if len(ops) > 2 else y64
    want = [y64b.detach(), *torch.autograd.grad(y64, r64[:2], gy.to(torch.bfloat16).double(),
                                                retain_graph=len(ops) > 2)]
    if len(ops) > 2:
        want.append(torch.autograd.grad(y64b, r64[2], gy.double())[0])
    pl = [t.clone().requires_grad_(True) for t in ops]
    yp = plain_fn(*(t.to(torch.bfloat16) for t in pl[:2])).float()
    yp = add_bias(yp, pl[2]) if len(ops) > 2 else yp
    parent = [yp.detach(), *torch.autograd.grad(yp, pl, gy)]
    row = {"family": family, "name": name, "route": "K3" if k3 else (
        "rounded_dot" if family != "gemm" else "cuBLAS fp32 out")}
    for key, a, w_, p_ in zip(("y", "dx", "dw", "db"), got, want, parent):
        if a.dtype != torch.float32 or a.shape != w_.shape:
            fail(f"default_rung {name} {key}: {a.dtype} {tuple(a.shape)} against "
                 f"{tuple(w_.shape)}")
        row[f"{key}_rel_l2"] = rel_l2(a.double(), w_)
        row[f"{key}_parent_rel_l2"] = rel_l2(p_.double(), w_)
        row[f"{key}_limit"] = DENSE_REL if k3 else route_limit(terms[key])
        if not row[f"{key}_rel_l2"] <= row[f"{key}_limit"]:
            fail(f"default_rung {name} {key}: relative L2 {row[f'{key}_rel_l2']:.3g} from "
                 f"float64 (limit {row[f'{key}_limit']:.3g}, route {row['route']}, "
                 f"{terms[key]} products a sum)")

    def route_call():
        with training_scope("default", dev):
            out = route_fn(*leaves)
        torch.autograd.grad(out, leaves, gy)

    def library_call(dtype):
        lib = [t.to(dtype).requires_grad_(True) for t in ops[:2]]
        g = gy.to(dtype)
        return lambda: torch.autograd.grad(plain_fn(*lib), lib, g)

    row["ms"] = cuda_ms(route_call, iters=DENSE_ITERS, warmup=1)
    row["device_ms"], row["kernels"] = device_ms_of(route_call)
    row["bare_ms"] = cuda_ms(bare, iters=DENSE_ITERS, warmup=1) if k3 or family == "gemm" \
        else None
    row["library_ms"] = cuda_ms(library_call(torch.bfloat16), iters=DENSE_ITERS, warmup=1)
    row["library_fp32_ms"] = cuda_ms(library_call(torch.float32), iters=DENSE_ITERS, warmup=1)
    print(f"default_rung geometry: {family} {name}: route {row['route']}, relative L2 from "
          f"float64 (limit; parent) "
          + ", ".join(f"{k} {row[f'{k}_rel_l2']:.3g} ({row[f'{k}_limit']:.3g}; "
                      f"{row[f'{k}_parent_rel_l2']:.3g})"
                      for k in ("y", "dx", "dw", "db") if f"{k}_rel_l2" in row)
          + f"; fwd+bwd ms: route {row['ms']:.4f} (device {ms_text(row['device_ms'])}, "
          f"{row['kernels'] or '?'} kernels; bare {ms_text(row['bare_ms'])}), library bf16 "
          f"{row['library_ms']:.4f}, fp32 {row['library_fp32_ms']:.4f}", flush=True)
    return row


def conv2d_row(family: str, shape: tuple, co: int, k: tuple, stride: tuple, pad: tuple,
               gen: torch.Generator, dev: torch.device) -> dict:
    """rung_row of ops.conv.conv2d on x of ``shape`` [B, C, H, W] (seeded),
    fan-in uniform weights [co, C, *k] and a bias; bare: K3's three calls on
    the fold's operands."""
    B, C, H, W = shape
    x = torch.randn(shape, generator=gen).to(dev)
    w = ((torch.rand(co, C, *k, generator=gen) * 2 - 1) * (3 / (C * k[0] * k[1])) ** 0.5
         ).to(dev)
    b = (0.1 * torch.randn(co, generator=gen)).to(dev)
    f = conv_ops.conv2d_fold(tuple(x.shape), tuple(w.shape), stride, pad)
    x1, w1, conv, Ho, Wo = f.x(x), f.w(w), dict(dilation=f.Wo, padding=(0, 0)), f.Ho, f.Wo
    xb = _bf16_operand(x1.contiguous(), "x")
    gb = _bf16_operand(torch.randn(B, Ho * Wo, co, generator=gen).to(dev), "gy")

    def bare():
        denseconv.launch(xb, w1, b, **conv)
        denseconv.input_grad(gb, w1, x1.shape, **conv)
        denseconv.weight_grad(xb, gb, w1.shape, **conv)

    name = (f"B={B} {C}->{co} {H}x{W} k={k} s={stride} pad={pad} (fold: {x1.shape[2]}->{co} "
            f"T={x1.shape[1]} k={w1.shape[2]} d={conv['dilation']})")
    rows = B * Ho * Wo
    return rung_row(family, name,
                    lambda xx, ww, bb: conv_ops.conv2d(xx, ww, bb, stride=stride, padding=pad),
                    lambda xx, ww: F.conv2d(xx, ww, stride=stride, padding=pad),
                    lambda y, bb: y + bb[:, None, None], [x, w, b],
                    dict(y=w1.shape[1] * w1.shape[2], dx=co * w1.shape[2], dw=rows, db=rows),
                    bare, dev)


def transposed_row(B: int, T: int, ci: int, co: int, K: int, u: int, pad: int,
                   gen: torch.Generator, dev: torch.device) -> dict:
    """rung_row of ops.conv.conv_transpose1d (x [B, T, ci], w [ci, co, K])."""
    x = torch.randn(B, T, ci, generator=gen).to(dev)
    w = ((torch.rand(ci, co, K, generator=gen) * 2 - 1) * (3 / (ci * K)) ** 0.5).to(dev)
    b = (0.1 * torch.randn(co, generator=gen)).to(dev)
    f = conv_ops.conv_transpose1d_fold((B, T, ci), (ci, co, K), u, pad, 0)
    w1, conv, L, rows = f.w(w), dict(padding=f.padding), f.L, f.rows
    xb = _bf16_operand(x, "x")
    gb = _bf16_operand(torch.randn(B, T + conv["padding"][1], co * u, generator=gen).to(dev),
                       "gy")
    b1 = b.repeat_interleave(u)

    def bare():
        denseconv.launch(xb, w1, b1, dilation=1, **conv)
        denseconv.input_grad(gb, w1, x.shape, dilation=1, **conv)
        denseconv.weight_grad(xb, gb, w1.shape, dilation=1, **conv)

    def plain(xx, ww):
        return F.conv_transpose1d(xx.transpose(1, 2), ww, stride=u, padding=pad).transpose(1, 2)

    return rung_row("transposed", f"B={B} T={T} {ci}->{co} k={K} u={u} pad={pad} (fold: "
                    f"{ci}->{co * u} k={w1.shape[2]})",
                    lambda xx, ww, bb: conv_ops.conv_transpose1d(xx, ww, bb, stride=u,
                                                                 padding=pad),
                    plain, lambda y, bb: y + bb, [x, w, b],
                    dict(y=ci * w1.shape[2], dx=co * u * w1.shape[2], dw=B * rows, db=B * L),
                    bare, dev)


def gemm_row(spec: str, a_shape: tuple, b_shape: tuple, calls: dict, gen: torch.Generator,
             dev: torch.device) -> dict:
    """rung_row of a dot the "default" steps recorded (recording_dots):
    dot_at_rung or einsum_at_rung; bare: cuBLAS's three fp32-output
    products on the product's rounded operands."""
    a = torch.randn(a_shape, generator=gen).to(dev)
    b = (torch.randn(b_shape, generator=gen) / a_shape[-1] ** 0.5
         ).to(dev)
    pa, pb = product_operands(spec, a, b)
    ab, bb = pa.to(torch.bfloat16), pb.to(torch.bfloat16)
    with torch.no_grad():
        gb = precision._product(ab, bb).to(torch.bfloat16)

    def bare():
        precision._product(ab, bb)
        precision._product(gb, bb.transpose(-1, -2))
        precision._product(ab.transpose(-1, -2), gb)

    if spec == "matmul":
        route, plain = precision.dot_at_rung, torch.matmul
    else:
        route = functools.partial(precision.einsum_at_rung, spec)
        plain = functools.partial(torch.einsum, spec)
    return rung_row("gemm", f"{spec} {a_shape} x {b_shape} (product {tuple(pa.shape)} x "
                    f"{tuple(pb.shape)}; calls a step {calls})", route, plain, None, [a, b],
                    dict(y=pa.shape[-1], dx=pb.shape[-1], dw=pa.shape[-2]), bare, dev)


def mpd_geometries(B: int, T: int, c0: int) -> list[tuple]:
    """The period discriminators' conv2d calls on B wavs of T samples with c0
    input channels: (period, layer, [B, C, H, p], Co, k, stride, pad)."""
    out = []
    for p in MPD_PERIODS:
        H = -(-T // p)
        for i, (ci, co, k, s, pad) in enumerate([(c0, 32, 5, 3, 2), (32, 128, 5, 3, 2),
                                                  (128, 512, 5, 3, 2), (512, 1024, 5, 3, 2),
                                                  (1024, 1024, 5, 1, 2), (1024, 1, 3, 1, 1)]):
            out.append((p, i, (B, ci, H, p), co, (k, 1), (s, 1), (pad, 0)))
            H = (H + 2 * pad - k) // s + 1
    return out


def window_geometries(B: int, windows: tuple, hidden: int = 128) -> list[tuple]:
    """The window discriminators' three 3x3 stride-2 conv2d calls a window of
    80 mel bins: ([B, C, H, W], Co)."""
    out = []
    for t in windows:
        H, W, C = t, 80, 1
        for _ in range(3):
            out.append(((B, C, H, W), hidden))
            H, W, C = (H + 1) // 2, (W + 1) // 2, hidden
    return out


def default_rung_phase(seed: int, dev: torch.device, dense: DenseRecord) -> list[dict]:
    """Phase 8c: every family the "default" rung folds or multiplies, at the
    production geometries (rung_row each): the MPD's 30 conv2d calls at B=18
    x 8000 samples, the conditional MPD's first layer (two channels in), the
    window discriminators at Conan's B=24 (32/64/128 frames) and the
    vocoder's B=18 (8/16/32), the non-causal generator's four transposed
    convs at B=18, and every distinct dot shape the four "default" steps
    recorded (``dense.dots``); then K3's forward launches a step by path
    beside the count the recorded conv1d calls predict. Returns the rows."""
    gen = torch.Generator().manual_seed(seed + 19)
    t0 = time.perf_counter()
    rows = []
    for p, i, shape, co, k, s, pad in mpd_geometries(TRAIN_B, 8000, 1):
        rows.append(conv2d_row("mpd", shape, co, k, s, pad, gen, dev))
    for p, i, shape, co, k, s, pad in mpd_geometries(TRAIN_B, 8000, 2):
        if i == 0:
            rows.append(conv2d_row("cond_mpd", shape, co, k, s, pad, gen, dev))
    for family, B, windows in (("window_conan", CONAN_WINDOW_B, (32, 64, 128)),
                               ("window_vocoder", TRAIN_B, (8, 16, 32))):
        for shape, co in window_geometries(B, windows):
            rows.append(conv2d_row(family, shape, co, (3, 3), (2, 2), (1, 1), gen, dev))
    T, ci = 8000 // 320, 512
    for u, K in zip((8, 5, 4, 2), NONCAUSAL_KERNELS):
        rows.append(transposed_row(TRAIN_B, T, ci, ci // 2, K, u, (K - u) // 2, gen, dev))
        T, ci = T * u, ci // 2
    for (spec, a_shape, b_shape), calls in sorted(dense.dots.items(), key=str):
        rows.append(gemm_row(spec, a_shape, b_shape, calls, gen, dev))
    for family in dict.fromkeys(r["family"] for r in rows):
        mine = [r for r in rows if r["family"] == family]
        keys = [k for k in ("y", "dx", "dw", "db") if f"{k}_rel_l2" in mine[0]]
        print(f"default_rung sums, {family}: {len(mine)} geometries (routes "
              f"{dict(collections.Counter(r['route'] for r in mine))}), worst relative L2 from "
              f"float64 " + ", ".join(f"{k} {max(r[f'{k}_rel_l2'] for r in mine):.3g}"
                                      for k in keys)
              + ", at most " + ", ".join(
                  f"{k} {max(r[f'{k}_rel_l2'] / r[f'{k}_limit'] for r in mine):.3g}"
                  for k in keys) + " of its limit"
              + " (the parent's route " + ", ".join(
                  f"{k} {min(r[f'{k}_parent_rel_l2'] for r in mine):.3g}-"
                  f"{max(r[f'{k}_parent_rel_l2'] for r in mine):.3g}" for k in keys)
              + f"); fwd+bwd ms, one call each: route {sum(r['ms'] for r in mine):.4f} (device "
              f"{ms_text(total(r['device_ms'] for r in mine))}, bare "
              f"{ms_text(total(r['bare_ms'] for r in mine if r['bare_ms'] is not None))}), "
              f"library bf16 {sum(r['library_ms'] for r in mine):.4f}, fp32 "
              f"{sum(r['library_fp32_ms'] for r in mine):.4f}", flush=True)
    per_step = []
    for path, counts in dense.launches.items():
        n = dense.steps[path]
        per_step.append(f"{path} {counts['denseconv'] / n:g} (predicted "
                        f"{dense.predicted[path] / n:g}), dx {counts['denseconv_dx'] / n:g}, dw "
                        f"{counts['denseconv_dw'] / n:g}")
    print(f"default_rung: {len(rows)} geometries in {time.perf_counter() - t0:.1f} s, every "
          f"value and gradient within its limit of float64 (K3 DENSE_REL {DENSE_REL}, else "
          f"route_limit: ROUTE_REL {ROUTE_REL} or {ROUTE_SUM_HEADROOM:g} sqrt(n) 2^-24); K3 "
          f"forward launches a "
          f"step: {'; '.join(per_step)}",
          flush=True)
    return rows


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


def vocoder_options_phase(seed: int, dev: torch.device, rng: np.random.Generator,
                          dense: DenseRecord) -> dict:
    """The vocoder GAN with every option on at the shipped width and rung;
    then its B=2 step at "highest" against the CPU's, a non-causal step,
    and the "nn"/resblock-2 causal and NSF generators' apply. Returns this
    path's launches of the training kernels and K1-GAN's max abs error at
    the spectrogram discriminator's geometry."""
    hp = load_config(os.path.join(ROOT, "egs", "hifigan_shuffle.yaml"))
    shipped = hp["train_precision"]
    base = dict(hp, tb_log_interval=1, seed=seed)
    hp.update(use_cond_disc=True, use_spec_disc=True, use_fm_loss=True,
              accumulate_grad_batches=2, max_updates=OPT_MINI_STEPS, tb_log_interval=1,
              seed=seed)
    batch = train_batch(hp, rng, dev)
    wavs = batch["wavs"]
    T = wavs.shape[1]
    mlp = hp["mel_loss_param"]
    geoms = msd_grouped_geometries(T)

    # K1's GAN form at the spectrogram discriminator's geometry, the new one
    spec_cfg = MelConfig.from_hparams(hp)
    got, (got_grad,) = value_and_grads(lambda w: logmel_gan(w, spec_cfg), wavs)
    want, (want_grad,) = value_and_grads(lambda w: logmel_gan_reference(w, spec_cfg), wavs)
    name = f"vocoder_options logmel_gan {spec_cfg.n_mels} bins n_fft {spec_cfg.n_fft}"
    k1_err, k1_note = compare_logmel(name, got, want,
                                     lambda: logmel_gan_reference(wavs.double(), spec_cfg))
    k1_grad = rel_l2(got_grad, want_grad)
    if k1_grad > GRAD_REL:
        exact = rel_l2(got_grad, logmel_gan_route_grad(wavs, spec_cfg,
                                                       logmel_gan_exact(wavs, spec_cfg)))
        k1_note += f"; dwav {k1_grad:.3g} from the fp32 plain version, {exact:.3g} from exact"
        if exact > GRAD_REL:
            fail(f"{name} dwav: {k1_note} (limit {GRAD_REL})")

    # OPT_MINI_STEPS mini-steps through Trainer.fit, CUDA events between them
    events: list = []

    def batches():
        for _ in range(OPT_MINI_STEPS):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            yield batch
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    task = VocoderTask(hp)
    work = os.path.join(ROOT, "build", "chip_smoke_vocoder_options")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_train_launches()
    with recording_convs() as seen:
        state = Trainer(task, hp, work).fit(batches())
    torch.cuda.synchronize()
    launches = train_launches()
    grad_launches = {k: launches.pop(k) for k in ("groupconv_bf16_dx", "groupconv_bf16_dw")}
    k3 = dense.launches["vocoder_options"] = {k: launches.pop(k) for k in K3_NAMES}
    dense.steps["vocoder_options"] = OPT_MINI_STEPS
    dense.predicted["vocoder_options"] = k3_forward_pred(seen)
    if k3["denseconv"] != k3_forward_pred(seen) or not k3["denseconv_dx"] \
            or not k3["denseconv_dw"]:
        fail(f"vocoder_options: K3 launches {k3} over {OPT_MINI_STEPS} mini-steps; predicted "
             f"{k3_forward_pred(seen)} forward launches, dx and dw some")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    with open(os.path.join(work, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    # per mini-step: the mel loss's resolutions on y and y_hat, the
    # spectrogram discriminator's mel of y_hat (G) and of y and y_hat (D);
    # the MSD on y_hat and, for feature matching, y (G), on y and y_hat and
    # both again under the rolled mel (D)
    k1_pred = 2 * len(mlp["fft_sizes"]) + 3
    k2_pred = 6 * len(geoms)
    if launches != {"logmel_gan": k1_pred * OPT_MINI_STEPS,
                    "groupconv_bf16": k2_pred * OPT_MINI_STEPS, "groupconv": 0}:
        fail(f"vocoder_options: launches {launches} over {OPT_MINI_STEPS} mini-steps; predicted "
             f"logmel_gan {k1_pred}, groupconv_bf16 {k2_pred}, groupconv 0 a mini-step")
    if sum(r["skipped"] for r in records) or not all(
            np.isfinite(v) for r in records for v in r.values() if isinstance(v, float)):
        fail(f"vocoder_options: skipped updates or non-finite metrics {records}")
    if not all(grad_launches.values()):
        fail(f"vocoder_options: K2-bf16's backward launched {grad_launches}")
    launches.update(grad_launches)
    updates = [int(state[o]["gradient_step"]) for o in ("opt_g", "opt_d")]
    if updates != [OPT_MINI_STEPS // 2] * 2 or int(state["opt_g"]["mini_step"]) != 0:
        fail(f"vocoder_options: {updates} updates after {OPT_MINI_STEPS} mini-steps of 2")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.train_step(state, batch, torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    losses = ", ".join(f"{k} {v:.5g}" for k, v in records[-1].items()
                       if k not in ("step", "prefix", "skipped", "steps_per_s"))

    # what Accumulate spends on a mini-step that makes no update (the running
    # mean, a read of mini_step, zero updates; the inner chain runs on the
    # k-th only): both optimizers' Accumulate.update on such a mini-step
    # (mini_step 0 of 2) against the running mean alone, wall ms with the
    # card drained before and after, each parameter leaf standing in for its
    # gradient
    def wall_ms_of(fn, n: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    pairs = [(task.opt_g, state["opt_g"], state["params_g"]),
             (task.opt_d, state["opt_d"], state["params_d"])]
    acc_update_ms = wall_ms_of(lambda: [o.update(p, st, p) for o, st, p in pairs])
    mean_only_ms = wall_ms_of(lambda: [[a + (g - a) / (st["mini_step"] + 1) for a, g in zip(
        tree_leaves(st["acc"]), tree_leaves(p))] for _o, st, p in pairs])
    print(f"vocoder_options: egs/hifigan_shuffle.yaml as shipped (train_precision {shipped!r}, "
          f"{hp['upsample_initial_channel']}-channel generator) with use_cond_disc, "
          f"use_spec_disc, use_fm_loss and accumulate_grad_batches 2, random weights seed "
          f"{seed}, B={TRAIN_B} x {T} samples: K1-GAN at the spectrogram discriminator's "
          f"{spec_cfg.n_mels} bins (n_fft {spec_cfg.n_fft}, hop {spec_cfg.hop}) against its "
          f"plain version max abs {k1_err:.3g}, dwav relative L2 {k1_grad:.3g}"
          + (f" ({k1_note})" if k1_note else "")
          + f"; Trainer.fit {OPT_MINI_STEPS} mini-steps, {updates[0]} updates: ms per mini-step "
          f"(CUDA events) {[round(x, 3) for x in step_ms]}, median after 1 warm "
          f"{np.median(step_ms[1:]):.3f}; peak memory {peak_gb:.3f} GB; launches per mini-step "
          f"logmel_gan {launches['logmel_gan'] / OPT_MINI_STEPS:g} (predicted {k1_pred}), "
          f"groupconv_bf16 {launches['groupconv_bf16'] / OPT_MINI_STEPS:g} (predicted "
          f"{k2_pred}), its dx {launches['groupconv_bf16_dx'] / OPT_MINI_STEPS:g} and dw "
          f"{launches['groupconv_bf16_dw'] / OPT_MINI_STEPS:g}, groupconv (3xTF32) "
          f"{launches['groupconv']}, K3 {k3['denseconv'] / OPT_MINI_STEPS:g} (predicted "
          f"{k3_forward_pred(seen) / OPT_MINI_STEPS:g}), its dx "
          f"{k3['denseconv_dx'] / OPT_MINI_STEPS:g} and dw "
          f"{k3['denseconv_dw'] / OPT_MINI_STEPS:g}; one profiled mini-step: wall "
          f"{wall_ms:.3f} ms, device kernels {device_ms:.3f} ms (busy "
          f"{100 * device_ms / wall_ms:.1f}%), {sum(e.count for e in kernels)} kernels; largest: "
          + "; ".join(f"{e.key[:50]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in top)
          + f"; last losses: {losses}; Accumulate.update of G and D on a mini-step that "
          f"makes no update {acc_update_ms:.3f} ms wall, the running mean alone "
          f"{mean_only_ms:.3f} ms", flush=True)

    # the step with every option on at "highest": card against the CPU
    hp_check = dict(hp, train_precision="highest", accumulate_grad_batches=1)
    task_check = VocoderTask(hp_check)
    vocoder_step_check("vocoder_options", hp_check, task_check,
                       task_check.init_state(torch.Generator().manual_seed(seed + 2)),
                       {k: v[:CHECK_B] for k, v in batch.items()}, generic_witness=True)

    # one non-causal step at the shipped width and rung, then the other
    # generators' apply on one mel
    hp_nc = dict(base, generator_type="noncausal", upsample_kernel_sizes=NONCAUSAL_KERNELS)
    task_nc = VocoderTask(hp_nc)
    state_nc = task_nc.init_state(torch.Generator().manual_seed(seed + 3))
    nc_ms = []
    for _ in range(2):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state_nc, m_nc = task_nc.train_step(state_nc, batch)
        b.record()
        torch.cuda.synchronize()
        nc_ms.append(a.elapsed_time(b))
    if float(m_nc["skipped"]) or not all(np.isfinite(float(v)) for v in m_nc.values()):
        fail(f"vocoder_options: non-causal step metrics {m_nc}")
    apply_rows = []
    gen = torch.Generator(device=dev).manual_seed(seed)
    for label, cfg_over, hop in (("causal nn + resblock 2", {"upsample": "nn", "resblock": "2"},
                                  320),
                                 ("NSF with F0", NSF_RATES, 256)):
        hp_g = dict(base, **cfg_over)
        n = int(OPT_APPLY_SECONDS * SR / hop)
        mel = torch.randn(1, n, 80, generator=torch.Generator().manual_seed(seed)).to(dev)
        if label.startswith("NSF"):
            from conan_tpu_torch.models.vocoder.hifigan_nsf import NsfHifiGanGenerator as cls
            f0 = torch.full((1, n), 180.0, device=dev)
            f0[:, n // 3:n // 2] = 0.0
            kw = {"f0": f0, "generator": gen}
        else:
            from conan_tpu_torch.models.vocoder.hifigan import HifiGanGenerator as cls
            kw = {}
        g = cls(HifiGanConfig.from_hparams(hp_g))
        params = tree_map(lambda t: t.to(dev) if torch.is_tensor(t) else t,
                          g.init(torch.Generator().manual_seed(seed)))
        with torch.inference_mode(), precision_scope("exact", dev):
            g.apply(params, mel, **kw)
            ms = cuda_ms(lambda: g.apply(params, mel, **kw), iters=3, warmup=1)
            y = g.apply(params, mel, **kw)
        if tuple(y.shape) != (1, n * hop, 1) or not torch.isfinite(y).all():
            fail(f"vocoder_options: {label} apply gave {tuple(y.shape)}, finite "
                 f"{bool(torch.isfinite(y).all())}")
        apply_rows.append(f"{label} {ms:.3f} ms for {n} frames")
    print(f"vocoder_options generators: one non-causal step (kernels {NONCAUSAL_KERNELS}, "
          f"train_precision {shipped!r}, B={TRAIN_B}) {nc_ms[1]:.3f} ms (first {nc_ms[0]:.3f}), "
          f"losses finite; apply at width {base['upsample_initial_channel']} on a "
          f"{OPT_APPLY_SECONDS} s mel, exact, CUDA events: " + "; ".join(apply_rows), flush=True)
    return {"launches": launches, "logmel_gan_err": k1_err}


def read_int16_wav(path: str) -> np.ndarray:
    """A wav ``run_vc.save_wav`` wrote, scaled back by its 32767."""
    from scipy.io import wavfile

    return wavfile.read(path)[1].astype(np.float32) / 32767.0


def infer_phase(seed: int, dev: torch.device, dirs, train_work: str) -> int:
    """The training CLI's --infer: a synthesized test split binarized through
    K1, converted by ``train.run.main`` with the r5 random-weight
    checkpoints (the guard on every item, as egs/soak_r5/conan.yaml ships
    it); each written wav against a direct stream_scan of its mels; then the
    vocoder's --infer on the train phase's work dir. Returns K1's launches."""
    from conan_tpu_torch.data.datasets import ConanDataset
    from conan_tpu_torch.train import run as train_run

    work = os.path.join(ROOT, "build", "chip_smoke_infer")
    shutil.rmtree(work, ignore_errors=True)
    hp = load_config(os.path.join(ROOT, "egs", "soak_r5", "conan.yaml"))
    hp.update(processed_data_dir=os.path.join(work, "processed"),
              binary_data_dir=os.path.join(work, "binary"), test_prefixes=["tst"],
              valid_prefixes=[])
    conan_corpus(hp, np.random.default_rng([seed, 12]), INFER_SPEAKERS, INFER_UTTS,
                 INFER_FRAMES, prefix="tst")
    n_items = INFER_SPEAKERS * INFER_UTTS
    logmel.launches = 0
    ConanBinarizer(hp).process()
    torch.cuda.synchronize()
    launches = logmel.launches
    if launches != n_items:
        fail(f"infer: the binarizer launched the logmel kernel {launches} times for {n_items}")
    k1_err, k1_notes = binarized_mels_check(hp, dev, n_items, phase="infer")
    shutil.rmtree(os.path.join(dirs[0], "generated_last"), ignore_errors=True)
    argv = ["--config", os.path.join(ROOT, "egs", "soak_r5", "conan.yaml"), "--exp_name",
            dirs[0], "--infer", "--hparams",
            f"binary_data_dir={hp['binary_data_dir']},emformer_ckpt={dirs[1]},"
            f"vocoder_ckpt={dirs[2]}"]
    t0 = time.perf_counter()
    stats = train_run.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with open(os.path.join(stats["gen_dir"], "infer_manifest.json")) as f:
        manifest = json.load(f)
    hp_run = set_hparams(argv=argv, save=False)
    diffs = [it["guard"]["max_abs_stream_vs_offline"] for it in manifest["items"]
             if it["guard"]]
    if not manifest["guard_passed"] or manifest["guard_checked"] != n_items \
            or hp_run["test_consistency_interval"] != 1 or max(diffs) > 1e-3:
        fail(f"infer: manifest guard {manifest['guard_passed']}, {manifest['guard_checked']} "
             f"checked, worst {max(diffs):.3g}")
    # each written wav against a direct stream_scan of the same mels
    eng = build_engine(dirs[0], dirs[1], dirs[2], hp_run)
    ds = ConanDataset(hp["binary_data_dir"], "test", hp_run)
    seg, hop = eng.cfg.seg, eng.cfg.mel.hop
    ref_lengths, wav_err = set(), 0.0
    for i in range(len(ds)):
        s = ds[i]
        T = len(s["content"])
        ref_lengths.add(len(s["ref_mel"]))
        src = torch.from_numpy(s["mel"][None]).to(dev)
        ref = torch.from_numpy(s["ref_mel"][None]).to(dev)
        noise = eng._f0_noise(1, -(-T // seg) * seg, torch.Generator().manual_seed(i), None)
        direct = np.clip(eng.stream_mels(src, ref, use_scan=True, f0_noise=noise)[0][0]
                         .cpu().numpy(), -1.0, 1.0)
        written = read_int16_wav(os.path.join(stats["gen_dir"], f"{s['item_name']}.wav"))
        if written.shape != (T * hop,):
            fail(f"infer: {s['item_name']} wrote {written.shape} samples, not {T * hop}")
        wav_err = max(wav_err, float(np.abs(written - direct).max()))
    if wav_err > 1 / 32767 + CAPTURED_ATOL:
        fail(f"infer: written wavs off a direct stream_scan by {wav_err:.3g}")
    if len(stats["capture_ms"]) != len(ref_lengths):
        fail(f"infer: {len(stats['capture_ms'])} captures for {len(ref_lengths)} reference "
             f"lengths")
    rtf = [w / a for w, a in zip(stats["wall_s"], stats["audio_s"])]
    print(f"infer: the training CLI's --infer (train.run.main, egs/soak_r5/conan.yaml, "
          f"test_consistency_interval {hp_run['test_consistency_interval']}) on {n_items} "
          f"synthesized test utterances of {[it['frames'] for it in manifest['items']]} frames "
          f"(ConanBinarizer: K1 x{launches}, stored mels against the plain version max abs "
          f"{k1_err:.3g}" + (f"; {'; '.join(k1_notes)}" if k1_notes else "") + ") with the main "
          f"phase's r5 random-weight checkpoints (seed {seed}): {len(manifest['items'])} items, "
          f"guard passed on {manifest['guard_checked']}, worst stream-vs-offline "
          f"{max(diffs):.3g} (atol {manifest['consistency_atol']}); {len(stats['capture_ms'])} "
          f"captures for {len(ref_lengths)} reference lengths, "
          f"{[round(x, 1) for x in stats['capture_ms']]} ms; wall per item (stream_scan, "
          f"captures included) {[round(x, 3) for x in stats['wall_s']]} s, RTF "
          f"{[round(x, 4) for x in rtf]}; main() {wall_s:.2f} s in all; written wavs against a "
          f"direct stream_scan of the same mels max abs {wav_err:.3g} (int16 step "
          f"{1 / 32767:.3g} + {CAPTURED_ATOL})", flush=True)
    # the vocoder's --infer: copy-synthesis of the same split by the train
    # phase's generator, its guard on every item
    gen_dir = os.path.join(train_work, "generated_test")
    shutil.rmtree(gen_dir, ignore_errors=True)
    t0 = time.perf_counter()
    train_run.main(["--config", os.path.join(ROOT, "egs", "soak_r5", "vocoder.yaml"),
                    "--exp_name", train_work, "--infer", "--hparams",
                    f"binary_data_dir={hp['binary_data_dir']},test_consistency_interval=1"])
    torch.cuda.synchronize()
    voc_s = time.perf_counter() - t0
    written = sorted(os.listdir(gen_dir))
    if len(written) != n_items:
        fail(f"infer: the vocoder's --infer wrote {written}")
    print(f"infer vocoder: --infer on egs/soak_r5/vocoder.yaml for the train phase's work dir "
          f"(causal HifiGAN, step {TRAIN_STEPS}, guard on every item: chunked step against "
          f"apply within 1e-3): {len(written)} wavs in {voc_s:.2f} s", flush=True)
    return launches


def torch_import_phase(eng, dirs, src: np.ndarray, ref: np.ndarray,
                       dev: torch.device) -> int:
    """Phase 4e: the main phase's r5 random-weight checkpoints written as the
    original system's PyTorch state dicts (reference names, ``.pt``), read
    back through ``torch_compat`` and the generator's ``params_from_torch``
    onto the card: every mapped leaf equal to the native one, and
    ``infer_once`` through an engine on the mapped weights equal to the
    native engine's (max abs 0). Returns K1's launches on this path."""
    from conan_tpu_torch.checkpoint import load_ckpt_state, params_from_jax
    from conan_tpu_torch.infer.streaming import StreamingVoiceConversion
    from conan_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
    from conan_tpu_torch.utils import torch_compat

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_import")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = eng.cfg
    conan_state = load_ckpt_state(dirs[0])
    native = {"conan": params_from_jax(conan_state["params_g"], dev),
              "vq": params_from_jax(conan_state["vq_state"], dev),
              "emf": params_from_jax(load_ckpt_state(dirs[1], "params"), dev),
              "voc": params_from_jax(load_ckpt_state(dirs[2], "params_g"), dev)}
    voc = HifiGanGenerator(cfg.vocoder)
    t0 = time.perf_counter()
    sds = {"conan": torch_compat.conan_to_torch(native["conan"], native["vq"], cfg.conan),
           "emf": torch_compat.emformer_to_torchaudio(native["emf"]),
           "voc": voc.params_to_torch(native["voc"])}
    for name, sd in sds.items():
        torch.save(sd, os.path.join(work, f"{name}.pt"))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sds = {name: torch.load(os.path.join(work, f"{name}.pt"), weights_only=True)
           for name in sds}
    conan, vq = torch_compat.conan_from_torch(sds["conan"], cfg.conan)
    mapped = {"conan": conan, "vq": vq,
              "emf": torch_compat.emformer_from_torchaudio(sds["emf"], cfg.emformer.num_layers),
              "voc": voc.params_from_torch(sds["voc"])}
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    n_leaves = 0
    for name, tree in native.items():
        got = mapped[name]
        if tree_map(lambda t: (tuple(t.shape), t.dtype, t.device.type), got) != \
                tree_map(lambda t: (tuple(t.shape), t.dtype, t.device.type), tree):
            fail(f"torch_import: the mapped {name} tree differs from the native one in "
                 f"structure, shape, dtype or device")
        unequal = [i for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(tree)))
                   if not torch.equal(a, b)]
        if unequal:
            fail(f"torch_import: {len(unequal)} mapped {name} leaves differ from the native ones")
        n_leaves += len(tree_leaves(tree))
    imported = StreamingVoiceConversion(cfg, mapped["emf"], mapped["conan"], mapped["vq"],
                                        mapped["voc"], serving_precision="exact", device=dev)
    logmel.launches = 0
    want, codes_want = eng.infer_once(src, ref, collect_codes=True)
    got, codes_got = imported.infer_once(src, ref, collect_codes=True)
    torch.cuda.synchronize()
    launches = logmel.launches
    err = float(np.abs(got - want).max())
    if err != 0.0 or not np.array_equal(codes_got, codes_want):
        fail(f"torch_import: infer_once on the imported weights is {err:.3g} from the native "
             f"engine's (codes equal: {np.array_equal(codes_got, codes_want)}), not 0")
    sizes = ", ".join(f"{name} {len(sd)} keys "
                      f"{os.path.getsize(os.path.join(work, f'{name}.pt')) / 1e6:.1f} MB"
                      for name, sd in sds.items())
    print(f"torch_import: the main phase's r5 random-weight checkpoints as reference-named "
          f"PyTorch state dicts ({sizes}) written in {export_s:.2f} s, read back through "
          f"torch_compat (conan_from_torch, emformer_from_torchaudio) and "
          f"HifiGanGenerator.params_from_torch onto the card in {import_s:.2f} s: {n_leaves} "
          f"leaves equal to the native ones; infer_once on the imported weights against the "
          f"native engine ({len(src) / SR:.2f} s src): max abs {err:.3g}, codes equal; logmel "
          f"launches {launches}; phase wall {time.perf_counter() - t_phase:.2f} s", flush=True)
    return launches


def rmvpe_phase(seed: int, dev: torch.device, smi: str) -> int:
    """Phase 10: RMVPE at the published geometry (E2E0, 4 blocks a level)
    from seeded weights written as an ``rmvpe.pt`` under the reference's
    names, loaded by ``RMVPE.from_torch_checkpoint`` on the card: its
    salience on a RMVPE_SECONDS synthesized clip against the CPU's (max abs,
    argmax flips), timed at B=1, profiled; then ``extract_f0.main`` over a
    4-utterance corpus and ``run_binarize.main`` (K1): each record's f0
    equal to the written ``_f0.npy`` cut to its length. Returns K1's
    launches on this path."""
    from conan_tpu_torch.data import extract_f0, run_binarize
    from conan_tpu_torch.models.rmvpe import E2E0, RMVPE

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_rmvpe")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ckpt = os.path.join(work, "rmvpe.pt")
    model = E2E0()
    torch.save({"model": model.params_to_torch(model.init(torch.Generator().manual_seed(seed)))},
               ckpt)
    t0 = time.perf_counter()
    card = RMVPE.from_torch_checkpoint(ckpt)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cpu = RMVPE.from_torch_checkpoint(ckpt, device="cpu")
    wav, _f0 = synth_wav(np.random.default_rng([seed, 13]), RMVPE_SECONDS, with_f0=True)
    x = torch.from_numpy(wav[None])
    xd = x.to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = card.salience(xd)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = got.cpu()
    t0 = time.perf_counter()
    want = cpu.salience(x)
    cpu_s = time.perf_counter() - t0
    if got.shape != (1, len(wav) // 160 + 1, 360) or not torch.isfinite(got).all():
        fail(f"rmvpe: salience of shape {tuple(got.shape)}, finite "
             f"{bool(torch.isfinite(got).all())}")
    err = float((got - want).abs().max())
    flips = int((got.argmax(-1) != want.argmax(-1)).sum())
    if err > RMVPE_ATOL:
        fail(f"rmvpe: the card's salience is {err:.3g} from the CPU's (atol {RMVPE_ATOL})")
    ms = cuda_ms(lambda: card.salience(xd), iters=RMVPE_ITERS, warmup=2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    card.salience(xd)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        card.salience(xd)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    print(f"rmvpe: E2E0 at the published geometry (n_blocks 4, 16-512 channels, BiGRU "
          f"384 -> 2x256), random weights seed {seed} written as {os.path.basename(ckpt)} "
          f"under the reference's names, from_torch_checkpoint onto the card in {load_s:.2f} "
          f"s; {RMVPE_SECONDS:.0f} s synthesized clip ({got.shape[1]} frames, fp32, TF32 off): "
          f"card vs CPU salience max abs {err:.3g} (atol {RMVPE_ATOL}), argmax flips {flips} of "
          f"{got.shape[1]}; B=1 salience {ms:.3f} ms (CUDA events, mean of {RMVPE_ITERS} after "
          f"warmup; first call {1e3 * first_s:.1f} ms, the CPU's {1e3 * cpu_s:.1f} ms), RTF "
          f"{ms / 1e3 / RMVPE_SECONDS:.5f}; peak memory above the weights {peak_gb:.3f} GB; "
          f"profiled call: device kernels {device_ms:.3f} ms, "
          f"{sum(e.count for e in kernels)} kernels; largest: "
          + "; ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in top) + f" [{smi}]", flush=True)
    # extract_f0 into the binarizer: a corpus without F0 files, then the CLIs
    hp = load_config(os.path.join(ROOT, "egs", "soak_r5", "conan.yaml"))
    hp.update(processed_data_dir=os.path.join(work, "processed"),
              binary_data_dir=os.path.join(work, "binary"), valid_prefixes=[],
              test_prefixes=[])
    conan_corpus(hp, np.random.default_rng([seed, 14]), 2, RMVPE_UTTS // 2, INFER_FRAMES,
                 prefix="f0")
    shutil.rmtree(os.path.join(hp["processed_data_dir"], "wavs_f0"))
    overrides = (f"processed_data_dir={hp['processed_data_dir']},"
                 f"binary_data_dir={hp['binary_data_dir']},valid_prefixes=[],test_prefixes=[]")
    config = os.path.join(ROOT, "egs", "soak_r5", "conan.yaml")
    t0 = time.perf_counter()
    written = extract_f0.main(["--config", config, "--rmvpe_ckpt", ckpt, "--hparams", overrides])
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    if written != RMVPE_UTTS:
        fail(f"rmvpe: extract_f0 wrote {written} files for {RMVPE_UTTS} utterances")
    logmel.launches = 0
    run_binarize.main(["--config", config, "--hparams", overrides])
    torch.cuda.synchronize()
    launches = logmel.launches
    with open(os.path.join(hp["processed_data_dir"], "metadata.json")) as f:
        wav_fns = {r["item_name"]: r["wav_fn"] for r in json.load(f)}
    store = RecordReader(os.path.join(hp["binary_data_dir"], "train"))
    checked, voiced, frames = 0, 0, 0
    for i in range(len(store)):
        rec = store[i]
        f0 = np.load(extract_f0.f0_path(wav_fns[rec["item_name"]]))
        n_wav = len(load_wav(wav_fns[rec["item_name"]], SR))
        if f0.dtype != np.float32 or len(f0) != n_wav // hp["hop_size"] + 1:
            fail(f"rmvpe: {rec['item_name']}_f0.npy is {f0.dtype} x {len(f0)}")
        if not np.array_equal(rec["f0"], f0[:rec["len"]]):
            fail(f"rmvpe: the record of {rec['item_name']} does not hold its extracted f0")
        checked, voiced, frames = checked + 1, voiced + int((f0 > 0).sum()), frames + len(f0)
    store.close()
    if checked != RMVPE_UTTS or launches != RMVPE_UTTS:
        fail(f"rmvpe: {checked} records checked, K1 launched {launches} times, for "
             f"{RMVPE_UTTS} utterances")
    print(f"rmvpe extract_f0: extract_f0.main on {RMVPE_UTTS} synthesized utterances of "
          f"{INFER_FRAMES[0]}-{INFER_FRAMES[1]} frames (egs/soak_r5/conan.yaml, hop "
          f"{hp['hop_size']}) on the card in {extract_s:.2f} s, {written} files, voiced "
          f"{voiced} of {frames} frames; run_binarize.main (ConanBinarizer, K1 x{launches}): "
          f"every record's f0 equals its _f0.npy cut to the record's length; phase wall "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# data parallelism: dist_train (2 gloo ranks on the card), nccl1, shard
# ---------------------------------------------------------------------------
def tree_hash(tree) -> str:
    """sha256 over the bytes of every tensor leaf in sorted key order: equal
    hashes on two ranks mean bit-identical trees."""
    h = hashlib.sha256()
    for leaf in tree_leaves(dist.sorted_keys(tree)):
        if torch.is_tensor(leaf):
            h.update(leaf.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def first_moments(state: dict) -> list:
    """The vocoder's optimizers' first moments (after a first step, (1 - b1)
    times the clipped gradient), in sorted key order (a rank's tree comes
    back from ``broadcast_state`` sorted)."""
    return tree_leaves(dist.sorted_keys([state["opt_g"]["mu"], state["opt_d"]["mu"]]))


def float64_card_step(task, state0: dict, batch: dict):
    """``task``'s step from ``state0`` on ``batch`` in float64 on the card:
    the plain versions of K1 and K2 (the kernels take fp32), cuDNN's float64
    convolutions."""
    from conan_tpu_torch.ops import conv as conv_ops
    from conan_tpu_torch.train import losses as losses_mod
    from conan_tpu_torch.train import tasks as tasks_mod

    to64 = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
    saved = conv_ops.groupconv, losses_mod.logmel_gan, tasks_mod.logmel_gan
    conv_ops.groupconv = grouped_conv1d_reference
    losses_mod.logmel_gan = tasks_mod.logmel_gan = logmel_gan_reference
    try:
        return task.train_step(tree_map(to64, state0), {k: to64(v) for k, v in batch.items()})
    finally:
        conv_ops.groupconv, losses_mod.logmel_gan, tasks_mod.logmel_gan = saved


def dist_vocoder_hp(seed: int) -> dict:
    hp = load_config(os.path.join(ROOT, "egs", "soak_r5", "vocoder.yaml"))
    return dict(hp, train_precision="highest", max_updates=DIST_STEPS, tb_log_interval=1,
                seed=seed)


def dist_conan_hp(seed: int) -> dict:
    hp = load_config(os.path.join(ROOT, "egs", "soak_r5", "conan.yaml"))
    return dict(hp, **CONAN_GATES, max_updates=DIST_CONAN_STEPS, tb_log_interval=1, seed=seed)


def dist_conan_batch(seed: int) -> dict:
    """DIST_CONAN_B synthesized rows of DIST_CONAN_T frames at the r5 width
    (80 bins; content codes below the vocabulary), the last rows shorter."""
    rng = np.random.default_rng([seed, 9])
    B, T = DIST_CONAN_B, DIST_CONAN_T
    batch = {"content": rng.integers(0, 100, (B, T)),
             "mels": (rng.standard_normal((B, T, 80)) * 0.5 - 4.0).astype(np.float32),
             "f0": (rng.standard_normal((B, T)) * 0.5 + 7.5).astype(np.float32),
             "uv": (rng.random((B, T)) < 0.25).astype(np.float32)}
    for i, n in enumerate(np.linspace(T, T * 3 // 4, B).astype(int)):
        batch["content"][i, n:] = -1
        for k in ("mels", "f0", "uv"):
            batch[k][i, n:] = 0
    batch["ref_mels"] = batch["mels"]
    batch["spk_ids"] = np.zeros(B, np.int64)
    return batch


def highest_step_launches(hp) -> dict:
    """What one vocoder step at "highest" launches, by the code's structure:
    K1-GAN at the mel loss's resolutions on y and y_hat, K2 on the MSD's 15
    grouped layers on y_hat in the generator step and on y and y_hat in the
    discriminator step; K2-bf16, its dx and dw, K3, its dx and dw none (the
    "default" rung's)."""
    return {"logmel_gan": 2 * len(hp["mel_loss_param"]["fft_sizes"]), "groupconv": 3 * 15,
            "groupconv_bf16": 0, "groupconv_bf16_dx": 0, "groupconv_bf16_dw": 0,
            "denseconv": 0, "denseconv_dx": 0, "denseconv_dw": 0}


def dist_rank_main(rank: int, out_dir: str, seed: int) -> None:
    """One rank of the dist_train phase (this script run with --dist_rank):
    joins a gloo group of DIST_RANKS on cuda:0 through a file rendezvous in
    ``out_dir``, then (1) one vocoder step at production width from the
    parent's seed on its rows of the parent's batch, (2) once the parent
    has finished its one-rank references (``refs_done`` in ``out_dir``),
    Trainer.fit for DIST_STEPS steps (CUDA events, peak memory, launches),
    (3) ``all_reduce_grads`` alone on buffers of the generator's and the
    discriminator's gradients, DIST_STEPS times (CUDA events and wall), (4)
    ConanTask at the r5 width through Trainer.fit across the k-means hook.
    Writes rank<R>.json (and rank 0 the step's first moments) for the
    parent."""
    dev = torch.device("cuda:0")
    world = dist.init_distributed(dev, backend="gloo", init_method=f"file://{out_dir}/rdv",
                                  rank=rank, world_size=DIST_RANKS,
                                  timeout=datetime.timedelta(seconds=DIST_COLLECTIVE_S))
    res: dict = {"rank": rank}
    hp = dist_vocoder_hp(seed)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"))
    batch = dist.local_rows({k: v.to(dev) for k, v in inputs["batch"].items()}, world)
    task = VocoderTask(hp, world=world)
    state0 = dist.broadcast_state(task.init_state(torch.Generator().manual_seed(seed + 1)),
                                  world)
    zero_train_launches()
    new, metrics = task.train_step(state0, batch)
    torch.cuda.synchronize()
    res["check"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                    "hash": tree_hash({k: new[k] for k in ("params_g", "params_d", "opt_g",
                                                           "opt_d")}),
                    "launches": train_launches(), "rows": len(batch["wavs"])}
    if rank == 0:
        torch.save([t.cpu() for t in first_moments(new)], os.path.join(out_dir, "mu_rank0.pt"))
    del new, state0
    deadline = time.monotonic() + DIST_RANK_TIMEOUT_S
    while not os.path.exists(os.path.join(out_dir, "refs_done")):
        if time.monotonic() > deadline:
            raise TimeoutError("the parent's one-rank references did not finish")
        time.sleep(0.05)
    events: list = []

    def batches():
        for _ in range(DIST_STEPS):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            yield batch
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    work = os.path.join(out_dir, "vocoder")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_train_launches()
    state = Trainer(task, hp, work).fit(batches())
    torch.cuda.synchronize()
    res["fit"] = {"ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])],
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "launches": train_launches(),
                  "hash": tree_hash(state), "step": int(state["step"])}
    # the gradients' all-reduce alone: one buffer per optimizer, as the step
    # sums them; both ranks hold the same parameters, so the sum is 2 x each
    bufs = [[t.detach().clone() for t in tree_leaves(state[k])]
            for k in ("params_g", "params_d")]
    ar_ms, ar_wall = [], []
    for _ in range(DIST_STEPS + 1):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        summed = [dist.all_reduce_grads(g, world) for g in bufs]
        b.record()
        torch.cuda.synchronize()
        ar_wall.append((time.perf_counter() - t0) * 1e3)
        ar_ms.append(a.elapsed_time(b))
    if not all(torch.equal(s, 2 * g) for sg, bg in zip(summed, bufs) for s, g in zip(sg, bg)):
        raise AssertionError("all_reduce_grads: the sum of two equal buffers is not 2 x each")
    res["all_reduce"] = {"ms": ar_ms[1:], "wall_ms": ar_wall[1:],
                         "mb": sum(t.numel() * t.element_size() for g in bufs for t in g) / 1e6}
    del state, task, bufs, summed
    hp_c = dist_conan_hp(seed)
    task_c = ConanTask(hp_c, world=world)
    batch_c = dist.local_rows(dist_conan_batch(seed), world)
    work_c = os.path.join(out_dir, "conan")
    state_c = Trainer(task_c, hp_c, work_c, use_random_ref_after=use_random_ref_after(
        hp_c, "conan")).fit(iter([batch_c] * DIST_CONAN_STEPS))
    res["conan"] = {"hash": tree_hash(state_c), "step": int(state_c["step"]),
                    "initialized": float(state_c["vq_state"]["initialized"])}
    if rank == 0:
        with open(os.path.join(work_c, "metrics.jsonl")) as f:
            res["conan"]["metrics"] = [json.loads(line) for line in f]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.shutdown(world)


def dist_train_phase(seed: int, dev: torch.device, smi: str) -> dict:
    """Phase 11: DIST_RANKS gloo ranks sharing the card (NCCL refuses two
    ranks on one device), each a subprocess of this script with its own
    timeout. The vocoder GAN step at production width (B = TRAIN_B split
    into contiguous blocks) is held to the one-rank step on the whole batch
    here, as the train phase holds the card's step: loss terms to the
    one-rank fp32 step at STEP_RTOL, every gradient leaf (the first moments
    after a first step) to the one-rank float64 step within
    max(STEP_GRAD_REL, STEP_FP32_FACTOR x the one-rank fp32 step's worst
    leaf). The ranks' states agree bit for bit after that step, after
    Trainer.fit, and after ConanTask's run across the k-means hook; each
    rank launches K1's GAN form and K2, and none of K2-bf16's three kernels,
    as the code predicts (``highest_step_launches``). Returns the launches
    of rank 0 (check step and Trainer.fit), every training kernel counted."""
    out = os.path.join(ROOT, "build", "chip_smoke_dist")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    hp = dist_vocoder_hp(seed)
    batch = train_batch(hp, np.random.default_rng([seed, 11]), dev)
    torch.save({"batch": {k: v.cpu() for k, v in batch.items()}}, os.path.join(out, "inputs.pt"))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                               "--dist_rank", str(r), "--dist_dir", out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(DIST_RANKS)]
    # the one-rank references while the ranks start: the fp32 step and the
    # float64 one (the plain versions of K1 and K2, cuDNN in float64); the
    # ranks time nothing until refs_done
    task = VocoderTask(hp)
    state0 = task.init_state(torch.Generator().manual_seed(seed + 1))
    new1, m1 = task.train_step(state0, batch)
    new64, _ = float64_card_step(task, state0, batch)
    mu64 = [t.cpu() for t in first_moments(new64)]
    witness = max(rel_l2(a.cpu(), b) for a, b in zip(first_moments(new1), mu64))
    del new1, new64
    torch.cuda.synchronize()
    open(os.path.join(out, "refs_done"), "w").close()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        fail(f"dist_train: a rank ran past {DIST_RANK_TIMEOUT_S} s (a hung collective?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    # the one-rank step timed with the card to itself, after the ranks exit
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(DIST_STEPS + 1)]
    state, _ = task.train_step(state0, batch)
    ev[0].record()
    for i in range(DIST_STEPS):
        state, _ = task.train_step(state, batch)
        ev[i + 1].record()
    torch.cuda.synchronize()
    one_rank_ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    del state, state0, task
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"dist_train: rank {r} exited {p.returncode}:\n{text[-3000:]}")
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    for key in ("check", "fit", "conan"):
        if len({r[key]["hash"] for r in ranks}) != 1:
            fail(f"dist_train: the ranks' states differ after {key}")
    if any(r["check"]["metrics"] != r0["check"]["metrics"] for r in ranks):
        fail("dist_train: the ranks' metrics differ")
    worst_loss = 0.0
    for k, v in m1.items():
        got, want = r0["check"]["metrics"][k], float(v)
        rel = abs(got - want) / max(abs(want), 1e-30)
        worst_loss = max(worst_loss, rel if k != "skipped" else 0.0)
        if k != "skipped" and rel > STEP_RTOL or k == "skipped" and got != want:
            fail(f"dist_train: {k} {got} on {DIST_RANKS} ranks, {want} on one (rtol {STEP_RTOL})")
    mu0 = torch.load(os.path.join(out, "mu_rank0.pt"))
    limit = max(STEP_GRAD_REL, STEP_FP32_FACTOR * witness)
    leaf_err = [rel_l2(a, b) for a, b in zip(mu0, mu64)]
    if len(mu0) != len(mu64) or max(leaf_err) > limit:
        fail(f"dist_train: gradient leaf {int(np.argmax(leaf_err))} relative L2 "
             f"{max(leaf_err):.3g} from the one-rank float64 step (limit {limit:.3g})")
    pred = highest_step_launches(hp)
    for r in ranks:
        if r["check"]["launches"] != pred or r["fit"]["launches"] != {
                k: n * DIST_STEPS for k, n in pred.items()} or r["fit"]["step"] != DIST_STEPS:
            fail(f"dist_train: rank {r['rank']} launches check {r['check']['launches']}, fit "
                 f"{r['fit']['launches']} ({r['fit']['step']} steps); predicted {pred} a step")
        if r["conan"]["step"] != DIST_CONAN_STEPS or r["conan"]["initialized"] != 1.0:
            fail(f"dist_train: ConanTask on rank {r['rank']}: {r['conan']}")
    conan_m = r0["conan"]["metrics"]
    if len(conan_m) != DIST_CONAN_STEPS or any(m["skipped"] for m in conan_m) or not all(
            np.isfinite(v) for m in conan_m for v in m.values() if isinstance(v, float)):
        fail(f"dist_train: ConanTask metrics {conan_m}")
    print(f"dist_train: {DIST_RANKS} gloo ranks on one card ({smi}), each a subprocess; "
          f"egs/soak_r5/vocoder.yaml at full width, train_precision highest, B={TRAIN_B} as "
          f"{' + '.join(str(r['check']['rows']) for r in ranks)}: the step against the one-rank "
          f"step on the whole batch: losses worst rel diff {worst_loss:.3g} (rtol {STEP_RTOL}), "
          f"gradient leaves worst rel L2 {max(leaf_err):.3g} from the one-rank float64 step "
          f"(limit {limit:.3g} = max({STEP_GRAD_REL}, {STEP_FP32_FACTOR} x witness "
          f"{witness:.3g}, the one-rank fp32 step's worst leaf); ranks bit-identical after the step, "
          f"after Trainer.fit ({DIST_STEPS} steps) and after ConanTask ({DIST_CONAN_STEPS} "
          f"steps of egs/soak_r5/conan.yaml at B={DIST_CONAN_B} x {DIST_CONAN_T}, gates "
          f"{CONAN_GATES}, the k-means hook run, VQ initialized); launches per rank per step "
          f"as predicted: " + ", ".join(f"{k} {n}" for k, n in pred.items())
          + "; ms per step (CUDA events) "
          + "; ".join(f"rank {r['rank']} {[round(x, 3) for x in r['fit']['ms']]} median "
                      f"{np.median(r['fit']['ms'][1:]):.3f}" for r in ranks)
          + f"; one rank on the whole batch, timed after the ranks exit, "
          f"{[round(x, 3) for x in one_rank_ms]} median {np.median(one_rank_ms):.3f}; "
          f"all_reduce_grads alone (G and D, {r0['all_reduce']['mb']:.1f} MB fp32) ms "
          "(CUDA events; wall) "
          + "; ".join(f"rank {r['rank']} {[round(x, 3) for x in r['all_reduce']['ms']]} "
                      f"({[round(x, 3) for x in r['all_reduce']['wall_ms']]})" for r in ranks)
          + "; peak memory per rank "
          f"{[round(r['fit']['peak_gb'], 3) for r in ranks]} GB; Conan losses at step "
          f"{DIST_CONAN_STEPS}: " + ", ".join(f"{k} {v:.5g}" for k, v in conan_m[-1].items()
                                              if k not in ("step", "prefix", "skipped",
                                                           "steps_per_s")), flush=True)
    return {name: sum(r0[k]["launches"][name] for k in ("check", "fit")) for name in pred}


def nccl1_phase(seed: int, dev: torch.device) -> dict:
    """Phase 12: one vocoder step (production width, B = CHECK_B) through
    an NCCL group of one rank against the same step with no group, with
    cuDNN's deterministic algorithms: every loss and every leaf of the new
    state equal bit for bit, and the launches of every training kernel as
    ``highest_step_launches`` predicts. Returns them."""
    out = os.path.join(ROOT, "build", "chip_smoke_nccl1")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    hp = dist_vocoder_hp(seed)
    small = {k: v[:CHECK_B] for k, v in train_batch(hp, np.random.default_rng([seed, 12]),
                                                      dev).items()}
    world = dist.init_distributed(dev, backend="nccl", init_method=f"file://{out}/rdv", rank=0,
                                  world_size=1,
                                  timeout=datetime.timedelta(seconds=DIST_COLLECTIVE_S))
    try:
        if tdist.get_backend() != "nccl":
            fail(f"nccl1: the group's backend is {tdist.get_backend()}")
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
            task = VocoderTask(hp)
            state0 = task.init_state(torch.Generator().manual_seed(seed + 3))
            new, m = task.train_step(state0, small)
            zero_train_launches()
            new_w, m_w = VocoderTask(hp, world=world).train_step(state0, small)
            torch.cuda.synchronize()
            launches = train_launches()
    finally:
        dist.shutdown(world)
    leaves, leaves_w = tree_leaves(dist.sorted_keys(new)), tree_leaves(dist.sorted_keys(new_w))
    differ = sum(not torch.equal(a, b) for a, b in zip(leaves, leaves_w))
    if differ or len(leaves) != len(leaves_w) or {k: float(v) for k, v in m.items()} != {
            k: float(v) for k, v in m_w.items()}:
        fail(f"nccl1: {differ} of {len(leaves)} state leaves (or the losses) differ from the "
             f"step with no group")
    if launches != highest_step_launches(hp):
        fail(f"nccl1: launches {launches}, predicted {highest_step_launches(hp)}")
    print(f"nccl1: one vocoder step (egs/soak_r5/vocoder.yaml, highest, B={CHECK_B}) through an "
          f"NCCL group of one rank equals the step with no group bit for bit: losses and all "
          f"{len(leaves)} state leaves; launches as predicted: "
          + ", ".join(f"{k} {n}" for k, n in launches.items()), flush=True)
    return launches


def shard_phase(eng, rng: np.random.Generator) -> int:
    """Phase 13: shard_streams with two shards on cuda:0, SHARD_B streams at
    the r5 geometry through the captured loop, against the unsharded
    captured run on the same batch: codes equal, wav to STREAM_ATOL; K1
    launched on each shard (its src and ref); the warm call's ms per chunk,
    sharded and not. Returns the sharded call's K1 launches."""
    src = np.stack([synth_wav(rng, SHARD_SECONDS) for _ in range(SHARD_B)])
    ref = np.stack([synth_wav(rng, SHARD_SECONDS / 2) for _ in range(SHARD_B)])
    sharded = copy.copy(eng)
    sharded.shard_streams(["cuda:0", "cuda:0"])
    timing = {}
    for name, e in (("unsharded", eng), ("sharded", sharded)):
        e.infer_once(src, ref, use_scan=True)               # captures
        torch.cuda.synchronize()
        logmel.launches = 0
        t0 = time.perf_counter()
        wav, codes = e.infer_once(src, ref, collect_codes=True, use_scan=True)
        timing[name] = (1e3 * (time.perf_counter() - t0), logmel.launches, wav, codes)
    n_chunks = -(-(src.shape[1] // eng.cfg.mel.hop + 1) // eng.cfg.seg)
    (u_ms, u_l, u_wav, u_codes), (s_ms, s_l, s_wav, s_codes) = timing["unsharded"], timing["sharded"]
    err = float(np.abs(s_wav - u_wav).max())
    if not np.array_equal(s_codes, u_codes) or err > STREAM_ATOL or s_l != 2 * len(
            sharded._shards) or u_l != 2:
        fail(f"shard: codes equal {np.array_equal(s_codes, u_codes)}, wav max abs {err:.3g} "
             f"(atol {STREAM_ATOL}), logmel launches {s_l} sharded, {u_l} unsharded")
    print(f"shard: shard_streams(['cuda:0', 'cuda:0']) on the main phase's engine, B={SHARD_B} "
          f"streams of {SHARD_SECONDS} s, use_scan (each shard its own captured graph): codes "
          f"equal to the unsharded captured B={SHARD_B} run, wav max abs {err:.3g} (atol "
          f"{STREAM_ATOL}); logmel launches {s_l} (2 a shard); warm call {s_ms:.3f} ms, "
          f"{s_ms / n_chunks:.4f} ms per chunk over {n_chunks} chunks (unsharded "
          f"{u_ms:.3f} ms, {u_ms / n_chunks:.4f} ms per chunk); host wall clock around "
          f"infer_once, mels and copies included", flush=True)
    return s_l


def saved_and_loaded(work_dir: str, key: str, params, dev: torch.device):
    """``params`` written as ``work_dir``'s checkpoint under ``key`` and read
    back onto ``dev``."""
    save_checkpoint(work_dir, 0, {key: params})
    return params_from_jax(load_ckpt_state(work_dir, key), dev)


def emformer_both_check(seed: int, dev: torch.device, root: str) -> str:
    """``EmformerDistillModel(mode="both")`` at the r5 Emformer geometry on
    seeded random weights: the card's step chunk by chunk against its apply
    over the stream (both heads to STREAM_ATOL, codes equal), the card's
    apply against the CPU's on the same weights (STREAM_ATOL), ms per step."""
    cfg = EmformerConfig.from_hparams(load_config(os.path.join(ROOT, "egs", "soak_r5",
                                                               "emformer.yaml")))
    model = EmformerDistillModel(cfg, mode="both")
    gen = torch.Generator().manual_seed(seed)
    params = saved_and_loaded(os.path.join(root, "emformer_both"), "params",
                              model.init(gen), dev)
    params_cpu = tree_map(lambda x: x.cpu(), params)
    seg, rc = cfg.segment_length, cfg.right_context_length
    mel = torch.randn(1, LEFTOVER_EMF_SEGS * seg + rc, cfg.input_dim, generator=gen)
    mel_dev = mel.to(dev)
    with torch.inference_mode(), precision_scope("exact", dev):
        full = model.apply(params, mel_dev)
        state = model.init_state(1, dev)
        outs, events = [], []
        for s in range(LEFTOVER_EMF_SEGS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out, state = model.step(params, state, mel_dev[:, s * seg:s * seg + seg + rc])
            b.record()
            outs.append(out)
            events.append((a, b))
        torch.cuda.synchronize()
        cpu = model.apply(params_cpu, mel)
    ms = [a.elapsed_time(b) for a, b in events[1:]]
    stepped = [torch.cat([o[i] for o in outs], 1) for i in range(2)]
    names = ("logits", "features")
    if [tuple(x.shape) for x in full] != [(1, LEFTOVER_EMF_SEGS * seg, 100),
                                          (1, LEFTOVER_EMF_SEGS * seg, 768)]:
        fail(f"emformer_both: head shapes {[tuple(x.shape) for x in full]}")
    step_err = [float((a - b).abs().max()) for a, b in zip(stepped, full)]
    cpu_err = [float((a.cpu() - b).abs().max()) for a, b in zip(full, cpu)]
    codes_equal = torch.equal(stepped[0].argmax(-1), full[0].argmax(-1))
    cpu_flips = int((full[0].argmax(-1).cpu() != cpu[0].argmax(-1)).sum())
    if not all(torch.isfinite(x).all() for x in full) or not codes_equal \
            or max(step_err + cpu_err) > STREAM_ATOL:
        fail(f"emformer_both: step vs apply max abs {step_err}, codes equal {codes_equal}; "
             f"card vs CPU {cpu_err} (atol {STREAM_ATOL})")
    return (f"emformer_both: r5 geometry ({cfg.num_layers} layers, segment {seg}, right "
            f"context {rc}), mode both, random weights seed {seed}, exact, B=1, "
            f"{LEFTOVER_EMF_SEGS} segments: step vs apply max abs "
            + ", ".join(f"{n} {e:.3g}" for n, e in zip(names, step_err))
            + f" (atol {STREAM_ATOL}), codes equal; card vs CPU apply max abs "
            + ", ".join(f"{n} {e:.3g}" for n, e in zip(names, cpu_err))
            + f" (atol {STREAM_ATOL}), code flips {cpu_flips}; step median "
            f"{np.median(ms):.3f} ms p90 {np.percentile(ms, 90):.3f} ms (CUDA events)")


def flow_dyn_clip_check(seed: int, dev: torch.device, root: str) -> str:
    """The flow F0 head of egs/conan_emformer_flow.yaml (a 10x192 DiffNet,
    K = 100), seeded random weights (the zero-init head too): the chunk step
    with a dynamic clip captured into a CUDA graph, the bounds in static
    tensors refilled per chunk, against the eager step on every chunk
    (CAPTURED_ATOL); the bounds bind (the eager result moves by more than
    1e-2 without them) and hold (with K = 100 of 1000 steps the last Euler
    step lands on the clipped x1: within 1e-6 of the bounds); eager and
    replay ms per chunk."""
    hp = load_config(os.path.join(ROOT, "egs", "conan_emformer_flow.yaml"))
    ccfg = ConanConfig.from_hparams(hp)
    conan = Conan(ccfg)
    gen = torch.Generator().manual_seed(seed)
    params = conan.f0_net.init(gen)
    params["out_proj"]["w"] = 0.3 * torch.randn(params["out_proj"]["w"].shape, generator=gen)
    params = saved_and_loaded(os.path.join(root, "flow"), "f0_net", params, dev)
    flow, seg, H = conan.f0_stream, LEFTOVER_FLOW_SEG, ccfg.hidden_size
    n = LEFTOVER_FLOW_CHUNKS
    cond = torch.randn(n, 1, seg, H, generator=gen).to(dev)
    x0 = torch.randn(n, 1, seg, 1, generator=gen).to(dev)
    lo = (-0.3 + 0.1 * torch.rand(n, 1, seg, 1, generator=gen)).to(dev)
    hi = (0.1 + 0.1 * torch.rand(n, 1, seg, 1, generator=gen)).to(dev)
    with torch.inference_mode(), precision_scope("exact", dev):
        state = flow.init_state(1, dev)
        eager, events = [], []
        for i in range(n):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            y, state = flow.step(params, state, cond[i], x0[i], dyn_clip=(lo[i], hi[i]))
            b.record()
            eager.append(y)
            events.append((a, b))
        unclipped, _ = flow.step(params, flow.init_state(1, dev), cond[0], x0[0])
        torch.cuda.synchronize()
        eager_ms = [a.elapsed_time(b) for a, b in events[1:]]
        bufs = {"state": flow.init_state(1, dev), "cond": cond[0].clone(), "x0": x0[0].clone(),
                "lo": lo[0].clone(), "hi": hi[0].clone()}

        def chunk():
            return flow.step(params, bufs["state"], bufs["cond"], bufs["x0"],
                             dyn_clip=(bufs["lo"], bufs["hi"]))

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                chunk()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y_buf, new_state = chunk()
            for k, v in new_state.items():
                bufs["state"][k].copy_(v)
        for v in bufs["state"].values():
            v.zero_()
        captured, events = [], []
        for i in range(n):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for name, src in (("cond", cond), ("x0", x0), ("lo", lo), ("hi", hi)):
                bufs[name].copy_(src[i])
            graph.replay()
            b.record()
            captured.append(y_buf.clone())
            events.append((a, b))
        torch.cuda.synchronize()
    replay_ms = [a.elapsed_time(b) for a, b in events[1:]]
    err = max(float((c - e).abs().max()) for c, e in zip(captured, eager))
    binds = float((eager[0] - unclipped).abs().max())
    outside = max(float(torch.maximum(l_ - e, e - h_).max()) for e, l_, h_ in zip(eager, lo, hi))
    if not all(torch.isfinite(e).all() for e in eager) or err > CAPTURED_ATOL or binds <= 1e-2 \
            or outside > 1e-6:
        fail(f"flow dyn_clip: captured vs eager max abs {err:.3g} (atol {CAPTURED_ATOL}), "
             f"clipped vs unclipped {binds:.3g} (must exceed 1e-2), x1 past its bounds by "
             f"{outside:.3g} (1e-6)")
    return (f"flow dyn_clip: egs/conan_emformer_flow.yaml's F0 flow (DiffNet "
            f"{ccfg.f0_residual_layers}x{ccfg.f0_residual_channels}, hidden {H}, K = "
            f"{ccfg.f0_k_step}), random weights seed {seed}, exact, B=1, {n} chunks of {seg} "
            f"frames, per-frame bounds in [-0.3, -0.2] / [0.1, 0.2] refilled each chunk: "
            f"captured vs eager max abs {err:.3g} (atol {CAPTURED_ATOL}); clipped vs unclipped "
            f"chunk 0 max abs {binds:.3g}, x1 past its bounds by at most {outside:.3g} (1e-6: the "
            f"last of K = 100 Euler steps lands on the clipped x1); eager chunk "
            f"median {np.median(eager_ms):.3f} ms, replay median {np.median(replay_ms):.3f} ms "
            f"(CUDA events)")


def bench_vocoder_check(seed: int, root: str) -> str:
    """``python -m conan_tpu_torch.infer.bench_vocoder`` as a subprocess on
    a checkpoint of egs/soak_r5/vocoder.yaml with fan-in scaled seeded
    weights: exit 0, both lines, consistency OK; its p50 and RTF."""
    hp = load_config(os.path.join(ROOT, "egs", "soak_r5", "vocoder.yaml"))
    d = os.path.join(root, "vocoder")
    gen = HifiGanGenerator(HifiGanConfig.from_hparams(hp))
    save_checkpoint(d, 0, {"params_g": fan_in_redraw(gen.init(torch.Generator().manual_seed(
        seed)), torch.Generator().manual_seed(seed + 1))}, hp)
    with open(os.path.join(d, "config.yaml"), "w") as f:
        json.dump(dict(hp), f)                      # JSON is YAML
    cmd = [sys.executable, "-m", "conan_tpu_torch.infer.bench_vocoder", "--ckpt_dir", d,
           "--chunks", str(LEFTOVER_BENCH_CHUNKS), "--chunk_frames", "4"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=LEFTOVER_BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()[-2:]
    m = re.search(r"p50 ([0-9.]+) ms, mean ([0-9.]+) ms, RTF ([0-9.]+)", lines[0] if lines else "")
    if r.returncode != 0 or m is None or len(lines) != 2 or not lines[1].endswith("(OK)"):
        fail(f"bench_vocoder: exit {r.returncode}, output {r.stdout[-2000:]!r}, "
             f"errors {r.stderr[-2000:]!r}")
    return (f"bench_vocoder: {' '.join(cmd[1:4])} on egs/soak_r5/vocoder.yaml "
            f"({hp['upsample_initial_channel']} channels, fan-in scaled random weights seed "
            f"{seed}), {LEFTOVER_BENCH_CHUNKS} chunks: exit 0 in {wall:.1f} s; p50 "
            f"{m.group(1)} ms, mean {m.group(2)} ms, RTF {m.group(3)} (CUDA events); "
            f"{lines[1]}")


def trace_check(eng, src: np.ndarray, ref: np.ndarray, root: str) -> tuple[str, int]:
    """``device_trace`` around one replay of the r5 engine's captured chunk
    step and TRACE_FRONTEND_CALLS frontend calls (K1 through its wrapper),
    ``sync`` at the end: the trace file exists and names as many kernels
    as the profiler's own count, more than a chunk's worth
    (TRACE_MIN_KERNELS). The profiler sometimes misses launches in a window
    (whole runs recorded the chunk's kernels but not a lone K1 launch
    before them, or 8 of 20 K1 launches three windows running): a window
    without the chunk, or without K1 (its name as the trace spells it holds
    ``logmel_fft_kernel``), is retaken, twice at most; K1 missing from the
    last is noted, the chunk missing fails. Returns the line and the
    frontend calls made (the chunk's inputs' two, then those in the
    windows)."""
    with torch.inference_mode():
        style = eng._prepare(eng.wav_to_mel(ref))
        mel_ext, _T, T_pad = eng._source_chunks(eng.wav_to_mel(src), True)
        chunks, noise_chunks = eng.scan_inputs(mel_ext, eng._f0_noise(1, T_pad, None, None))
        cap = eng._captured_step(eng.init_state(1), chunks[0], style, noise_chunks[0])
        calls = 2                                       # the mels of src and ref above
        for attempt in range(3):
            log_dir = os.path.join(root, f"trace{attempt}")
            shutil.rmtree(log_dir, ignore_errors=True)
            with device_trace(log_dir) as prof:
                cap.mel.copy_(chunks[0])
                cap.noise.copy_(noise_chunks[0])
                cap.graph.replay()
                mels = [eng.wav_to_mel(src) for _ in range(TRACE_FRONTEND_CALLS)]
                sync([mels, cap.wav])
            calls += TRACE_FRONTEND_CALLS
            files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
            if len(files) != 1:
                fail(f"trace: {len(files)} trace files in {log_dir}")
            with open(os.path.join(log_dir, files[0])) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            counted = sum(e.count for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA
                          and not e.key.startswith(("Memcpy", "Memset")))
            names = {e["name"] for e in kernels}
            k1 = [n for n in names if "logmel_fft_kernel" in n]
            if k1 and len(kernels) > TRACE_MIN_KERNELS:
                break
            print(f"trace: profiler window {attempt} recorded {len(kernels)} kernels, K1 "
                  f"{'among them' if k1 else 'not among them'}; retaken", flush=True)
    if len(kernels) != counted or len(kernels) <= TRACE_MIN_KERNELS:
        fail(f"trace: {len(kernels)} kernel events in {files[0]} ({counted} by key_averages)")
    by_time: dict = {}
    for e in kernels:
        by_time[e["name"]] = by_time.get(e["name"], 0.0) + e.get("dur", 0.0)
    top = sorted(by_time.items(), key=lambda kv: -kv[1])[:3]
    k1_events = sum(e["name"] in k1 for e in kernels)
    k1_text = (f"K1 as {k1[0][:60]!r} {k1_events} times" if k1
               else "K1 not recorded (the profiler missed its launches)")
    return (f"trace: device_trace around one captured r5 chunk and {TRACE_FRONTEND_CALLS} "
            f"frontend calls (window {attempt + 1}): "
            f"{os.path.relpath(os.path.join(log_dir, files[0]), ROOT)} "
            f"({os.path.getsize(os.path.join(log_dir, files[0]))} bytes), {len(kernels)} kernel "
            f"events ({counted} by key_averages), {len(names)} names, {k1_text}; longest: "
            + "; ".join(f"{k[:60]} {v:.1f} us" for k, v in top)), calls


def leftovers_phase(seed: int, dev: torch.device, eng, src: np.ndarray,
                    ref: np.ndarray) -> int:
    """Phase 14: the last modules ported from the JAX package, one line
    each: the Emformer's two-head mode, the flow's dynamic clip captured,
    the vocoder micro-harness's CLI and a device trace. Returns K1's
    launches on this path (the trace's frontend calls)."""
    root = os.path.join(ROOT, "build", "chip_smoke_leftovers")
    shutil.rmtree(root, ignore_errors=True)
    logmel.launches = 0
    for check in (lambda: emformer_both_check(seed, dev, root),
                  lambda: flow_dyn_clip_check(seed, dev, root),
                  lambda: bench_vocoder_check(seed, root)):
        t0 = time.perf_counter()
        print(f"{check()} [{time.perf_counter() - t0:.1f} s]", flush=True)
    t0 = time.perf_counter()
    line, calls = trace_check(eng, src, ref, root)
    print(f"{line} [{time.perf_counter() - t0:.1f} s]", flush=True)
    launches = logmel.launches
    if launches != calls:
        fail(f"leftovers: the logmel kernel launched {launches} times, not {calls} (the "
             f"trace's frontend calls)")
    return launches


def denseconv_entries(rows: list[dict], geoms: list[tuple], dense: DenseRecord) -> list[dict]:
    """The kernels line's entries of K3, its dx and its dw: sums over the
    denseconv phase's geometries (one call each), launches by path as each
    default run counted them, and the Conan k=31 layer's row."""
    k31 = next((r for r, g in zip(rows, geoms) if g[4] == 31), rows[0])
    by = {b: sum(r["bound_ms"] for r in rows if r["bound_by"] == b)
          for b in ("bytes", "operations")}
    out = []
    for k, name, source in (("fwd", "denseconv", "conan_tpu_torch/csrc/denseconv.cu"),
                            ("dx", "denseconv_dx", "conan_tpu_torch/csrc/denseconv.cu"),
                            ("dw", "denseconv_dw", "conan_tpu_torch/csrc/denseconv_bwd.cu")):
        by_path = {path: counts[name] for path, counts in dense.launches.items()}
        err = max(r[f"{k}_max_abs_err"] for r in rows)
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": "conan_tpu/ops/conv.py:68",
            "replaces_note": "no TPU kernel: the JAX package's dense conv and its VJP are "
                             "XLA's lax.conv_general_dilated",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err, "max_abs_diff": err,
            "rel_l2": max(r[f"{k}_rel_l2"] for r in rows),
            "parent_rel_l2": [min(r[f"{k}_parent_rel_l2"] for r in rows),
                              max(r[f"{k}_parent_rel_l2"] for r in rows)],
            "ms": sum(r[f"{k}_ms"] for r in rows),
            "kernel_device_ms": total(r[f"{k}_kernel_device_ms"] for r in rows),
            "launch_ms": sum(r[f"{k}_launch_ms"] for r in rows),
            "plain_ms": sum(r[f"{k}_plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": max(by, key=by.get),
            "library_ms": sum(r[f"{k}_library_ms"] for r in rows),
            "library_fp32_ms": sum(r[f"{k}_library_fp32_ms"] for r in rows),
            "geometries": len(rows),
            "k31_layer": {key: k31[f"{k}_{key}"] for key in
                          ("ms", "kernel_device_ms", "launch_ms", "plain_ms", "library_ms",
                           "library_fp32_ms", "rel_l2", "parent_rel_l2")}
            | {"bound_ms": k31["bound_ms"], "geometry": k31["geometry"]}})
    return out


def kernel_ranking(train_kernels: list[dict], rows: list[dict], geoms: list[tuple],
                   dense: DenseRecord) -> list[tuple]:
    """Every hand-written kernel of the training steps ranked by its launches
    in one "default" step of a task times its device ms above its bound a
    launch: K1-GAN (vocoder), K2-bf16 and its dx and dw (vocoder; 15
    geometries, the per-launch mean), K3 and its dx and dw by task (the mean
    over that task's geometries weighted by their calls a step; the bare
    launch where the profiler missed the kernel). K2 (3xTF32) and the
    serving K1 launch nothing in a "default" step. Returns (ms a step,
    kernel, task, launches a step, device ms, bound ms), largest first."""
    out = []
    by_name = {e["name"]: e for e in train_kernels}
    n_voc = dense.steps["train"]
    for name, per_step, n in (("logmel_gan", by_name["logmel_gan"]["launches"] / TRAIN_STEPS, 3),
                              ("groupconv_bf16", by_name["groupconv_bf16"]["launches"] / n_voc,
                               15),
                              ("groupconv_bf16_dx",
                               by_name["groupconv_bf16_dx"]["launches"] / n_voc, 15),
                              ("groupconv_bf16_dw",
                               by_name["groupconv_bf16_dw"]["launches"] / n_voc, 15)):
        dev_ms = by_name[name]["kernel_device_ms"]
        if dev_ms is None:
            dev_ms = by_name[name].get("launch_ms", by_name[name]["ms"])
        dev_ms, bound = dev_ms / n, by_name[name]["bound_ms"] / n
        out.append((per_step * (dev_ms - bound), name, "vocoder", per_step, dev_ms, bound))
    for path, task in (("train", "vocoder"), ("conan_train", "conan"),
                       ("postnet_train", "postnet")):
        mine = [(r, dense.geoms[g][task]) for r, g in zip(rows, geoms) if task in dense.geoms[g]]
        calls = sum(n for _, n in mine)
        for k, name in (("fwd", "denseconv"), ("dx", "denseconv_dx"), ("dw", "denseconv_dw")):
            def dev_of(r):
                d = r[f"{k}_kernel_device_ms"]
                return r[f"{k}_launch_ms"] if d is None else d
            dev_ms = sum(n * dev_of(r) for r, n in mine) / calls
            bound = sum(n * r["bound_ms"] for r, n in mine) / calls
            per_step = dense.launches[path][name] / dense.steps[path]
            out.append((per_step * (dev_ms - bound), name, task, per_step, dev_ms, bound))
    out.sort(key=lambda t: -t[0])
    print("kernel ranking by launches in one default step x (device - bound) ms a launch: "
          + "; ".join(f"{i + 1}. {name} ({task}) {n:g} x ({d:.4f} - {b:.4f}) = {ms:.3f} ms"
                      for i, (ms, name, task, n, d, b) in enumerate(out)), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trained", default="",
                    help="comma list of stages (conan, emf, voc) that load the trained "
                         "checkpoints/soak_r5_<stage>/deploy weights; the rest are random")
    ap.add_argument("--dist_rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist_dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dist_rank is not None:       # one rank of the dist_train phase
        if not torch.cuda.is_available():
            sys.exit(1)
        dist_rank_main(args.dist_rank, args.dist_dir, args.seed)
        return
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
    print(f"build: {', '.join(src.name for src in native.SOURCES)} by one nvcc each in "
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
          f"{ms_text(serve_device_ms)}), plain {plain_ms:.4f} ms, "
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
        by_path.update(flow=flow_phase(args.seed, src, ref), run_vc=run_vc_phase(eng, dirs, rng),
                       torch_import=torch_import_phase(eng, dirs, src, ref, dev))
        # 5. train, 6. conan_train, 7. emformer_train, 8. postnet_train
        dense = DenseRecord()
        train_kernels = train_phase(args.seed, dev, rng, dense)
        opt = vocoder_options_phase(args.seed, dev, rng, dense)
        for entry in train_kernels:
            entry["launches_by_path"] = {"train": entry["launches"],
                                         "vocoder_options": opt["launches"][entry["name"]]}
        train_kernels[0]["max_abs_err"] = train_kernels[0]["max_abs_diff"] = max(
            train_kernels[0]["max_abs_err"], opt["logmel_gan_err"])
        by_path["conan_train"] = conan_train_phase(args.seed, dev, dense)
        by_path["emformer_train"] = emformer_train_phase(args.seed, dev, smi, dirs, src, ref,
                                                          dense)
        postnet_train_phase(args.seed, dev, smi, dense)
        # 8b. denseconv
        dense_rows, dense_geoms = denseconv_phase(args.seed, dev, dense)
        train_kernels += denseconv_entries(dense_rows, dense_geoms, dense)
        # 8c. default_rung
        default_rung_phase(args.seed, dev, dense)
        kernel_ranking(train_kernels, dense_rows, dense_geoms, dense)
        # 9. infer
        by_path["infer"] = infer_phase(args.seed, dev, dirs,
                                       os.path.join(ROOT, "build", "chip_smoke_train"))
        # 10. rmvpe
        by_path["rmvpe"] = rmvpe_phase(args.seed, dev, smi)
        # 11. dist_train, 12. nccl1, 13. shard
        dist_launches = dist_train_phase(args.seed, dev, smi)
        nccl_launches = nccl1_phase(args.seed, dev)
        by_path["shard"] = shard_phase(eng, rng)
        # 14. leftovers
        by_path["leftovers"] = leftovers_phase(args.seed, dev, eng, src, ref)
        for entry in train_kernels:
            entry["launches_by_path"].update(
                dist_train=dist_launches[entry["name"]], nccl1=nccl_launches[entry["name"]])
            if entry["name"] in K3_NAMES:     # K3's paths are all training runs
                entry["launches"] = sum(entry["launches_by_path"].values())

    kernel = {"name": "logmel", "route": "cuda", "source": "conan_tpu_torch/csrc/logmel.cu",
              "replaces": "conan_tpu/ops/pallas_stft.py:52", "launches": launches,
              "launches_by_path": by_path,
              "max_abs_err": err, "max_abs_diff": err, "ms": ms,
              "kernel_device_ms": serve_device_ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}

    # 10. kernels line, 11. result line
    print(json.dumps({"kernels": [kernel, *train_kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
