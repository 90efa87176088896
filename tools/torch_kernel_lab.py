#!/usr/bin/env python3
"""Measurements of the PyTorch port's two CUDA kernels on one card, beside
chip_smoke.py, which checks and times them as they ship.

    python3 tools/torch_kernel_lab.py accuracy
    python3 tools/torch_kernel_lab.py sweep '{"name": {"B": "256, 32, 32, 32, 32, 2"}, ...}'

accuracy  K2 on the MSD's five grouped layers (B=3, T=1000 or 300) and K1's
          GAN form at its three n_fft (chip_smoke.py's B=18 x 8000 train
          batch, seed 0) against the same function in float64: max abs
          error of the kernel and of the fp32 plain version, K2's mean error
          signed along y (a biased accumulation shows there) and the
          gradients' relative L2 errors (the GAN form's through its analytic
          backward, against that route fed by the exact function, and what
          the plain version's fp32-rounded basis alone moves it).
sweep     csrc/groupconv.cu built once per variant into build/kernel_lab/.
          A variant replaces the template arguments <BM, BN, WM, WN, RK,
          STAGES> of some of groupconv_forward's four tile classes (A: cog
          >= 64; B: cog 32, s <= 2; C: cog 32, s 4; D: cog 16), or with
          "src" builds another source. Each is checked against cuDNN (TF32
          off, atol 2e-4 / rtol 1e-4) and timed kernel-only with CUDA events
          on the 15 MSD grouped geometries at B=18, T=8000; the shipped
          tiles run as "base".

Imports nothing of JAX or conan_tpu.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from conan_tpu_torch.ops import native  # noqa: E402
from conan_tpu_torch.ops.groupconv import (grouped_conv1d_reference, groupconv,  # noqa: E402
                                           kernel_weights)
from conan_tpu_torch.ops.logmel import logmel_gan, logmel_gan_reference  # noqa: E402
from conan_tpu_torch.train.losses import gan_mel_configs  # noqa: E402

MSD_LAYERS = [(128, 128, 2, 4), (128, 256, 2, 16), (256, 512, 4, 16), (512, 1024, 4, 16),
              (1024, 1024, 1, 16)]   # (ci, co, stride, groups), k 41, padding 20
CLASSES = "ABCD"                     # groupconv_forward's launch<...> lines, in order


def accuracy(dev: torch.device) -> None:
    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    for ci, co, s, g in MSD_LAYERS:
        rng = np.random.default_rng(ci + co)
        T = 1000 if ci <= 256 else 300
        x = torch.from_numpy(rng.standard_normal((3, T, ci)).astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.standard_normal((co, ci // g, 41)) / np.sqrt(41 * ci / g))
                             .astype(np.float32)).to(dev)
        kw = dict(stride=s, padding=(20, 20), groups=g)
        yk, (_, dwk) = cs.value_and_grads(lambda a, b: groupconv(a, b, **kw), x, w)
        yc, (_, dwc) = cs.value_and_grads(
            lambda a, b: grouped_conv1d_reference(a, b, **kw), x, w)
        y6, (_, dw6) = cs.value_and_grads(
            lambda a, b: grouped_conv1d_reference(a, b, **kw), x.double(), w.double())
        err = {name: float((y.double() - y6).abs().max()) for name, y in (("k", yk), ("c", yc))}
        bias = {name: float(((y.double() - y6) * torch.sign(y6)).mean())
                for name, y in (("k", yk), ("c", yc))}
        print(f"K2 {ci}->{co} s{s} g{g}: y max abs from float64: kernel {err['k']:.3g}, cuDNN "
              f"{err['c']:.3g}; mean signed error along y: kernel {bias['k']:.3g}, cuDNN "
              f"{bias['c']:.3g}; dw relative L2 from float64: kernel {rel(dwk, dw6):.3g}, "
              f"cuDNN {rel(dwc, dw6):.3g}", flush=True)
    rng = np.random.default_rng(0)     # chip_smoke.py's draws: src, ref, then the batch
    cs.synth_wav(rng, 5.12), cs.synth_wav(rng, 2.56)
    wavs = torch.from_numpy(np.stack([cs.synth_wav(rng, 0.5) for _ in range(18)])).to(dev)
    for cfg in gan_mel_configs(16000, 320, [512, 1024, 2048], [160] * 3, [512, 1024, 2048]):
        ok, (dk,) = cs.value_and_grads(lambda w: logmel_gan(w, cfg), wavs)
        op, (dp,) = cs.value_and_grads(lambda w: logmel_gan_reference(w, cfg), wavs)
        o6 = logmel_gan_reference(wavs.double(), cfg)
        exact = cs.logmel_gan_exact(wavs, cfg)
        de = cs.logmel_gan_route_grad(wavs, cfg, exact)
        d6 = cs.logmel_gan_route_grad(wavs, cfg, o6)
        print(f"K1-GAN n_fft {cfg.n_fft}: ln-mel max abs from the plain version in float64: "
              f"kernel {float((ok.double() - o6).abs().max()):.3g}, fp32 plain "
              f"{float((op.double() - o6).abs().max()):.3g}; from the exact function: kernel "
              f"{float((ok.double() - exact).abs().max()):.3g}; dwav relative L2 from the "
              f"exact-function route: kernel {rel(dk, de):.3g}, fp32 plain {rel(dp, de):.3g}, "
              f"the route fed by the plain version in float64 {rel(d6, de):.3g}", flush=True)


def sweep(dev: torch.device, variants: dict) -> None:
    src = open(os.path.join(ROOT, "conan_tpu_torch", "csrc", "groupconv.cu")).read()
    base = dict(zip(CLASSES, re.findall(r"launch<([\d, ]+)>\(", src)))
    out_dir = os.path.join(ROOT, "build", "kernel_lab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, over in {"base": {}, **variants}.items():
        over = dict(over)
        text = open(over.pop("src")).read() if "src" in over else src
        for cls, args in over.items():
            text = text.replace(f"launch<{base[cls]}>(", f"launch<{args}>(")
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [native._nvcc(), *native.NVCC_FLAGS, "-I", str(native.CSRC), path, "-o",
             os.path.join(out_dir, f"{name}.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", log))
        registers = re.findall(r"Used (\d+) registers", log)
        print(f"{name}: nvcc rc {proc.returncode}, registers {registers}, spill bytes {spills}",
              flush=True)
        if proc.returncode == 0:
            lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.groupconv_forward.argtypes = [P, P, P, P, *[I] * 9, P]
            libs[name] = lib
    gen = torch.Generator().manual_seed(0)
    totals = {name: 0.0 for name in ["cuDNN", *libs]}
    for scale, t, ci, co, k, s, g, pd in cs.msd_grouped_geometries(8000):
        x = torch.randn(cs.TRAIN_B, t, ci, generator=gen).to(dev)
        w = ((torch.rand(co, ci // g, k, generator=gen) * 2 - 1) / (k * ci // g) ** 0.5).to(dev)
        x_cf = x.transpose(1, 2).contiguous()
        want = F.conv1d(x_cf, w, stride=s, padding=pd, groups=g).transpose(1, 2)
        row = {"cuDNN": cs.cuda_ms(lambda: F.conv1d(x_cf, w, stride=s, padding=pd, groups=g),
                                   iters=20)}
        w_hi, w_lo = kernel_weights(w, g)
        y = torch.empty(want.shape, device=dev)   # contiguous [B, T_out, Co]
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in libs.items():
            def call():
                return lib.groupconv_forward(x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
                                             y.data_ptr(), cs.TRAIN_B, t, ci, want.shape[1], co,
                                             g, k, s, pd, stream)
            y.fill_(float("nan"))
            if call() != 0:
                row[name] = float("inf")
                continue
            torch.cuda.synchronize()
            wrong = not torch.allclose(y, want, atol=2e-4, rtol=1e-4)
            row[name] = float("nan") if wrong else cs.cuda_ms(call, iters=20)
        for name, ms in row.items():
            totals[name] += ms
        print(f"scale {scale} {ci}->{co} s{s} g{g} T{t}: "
              + " | ".join(f"{name} {ms:.4f}" for name, ms in row.items()), flush=True)
    print("sums (ms; nan: wrong, inf: refused): "
          + " | ".join(f"{name} {ms:.4f}" for name, ms in totals.items()))


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] not in ("accuracy", "sweep"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_lab: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    if sys.argv[1] == "accuracy":
        accuracy(dev)
    else:
        sweep(dev, json.loads(sys.argv[2]) if len(sys.argv) > 2 else {})


if __name__ == "__main__":
    main()
