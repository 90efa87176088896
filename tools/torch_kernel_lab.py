#!/usr/bin/env python3
"""Measurements of the PyTorch port's two CUDA kernels on one card, beside
chip_smoke.py, which checks and times them as they ship.

    python3 tools/torch_kernel_lab.py accuracy
    python3 tools/torch_kernel_lab.py sweep '{"name": {"B": "256, 32, 32, 32, 32, 2"}, ...}'
    python3 tools/torch_kernel_lab.py step [N]

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
step      chip_smoke.py's check of the card's B=2 vocoder train step against
          the CPU's, on more batches: seeds 0..N-1 (default 6) as
          chip_smoke.py draws them, and seed 0 after five more draws (the
          batch the train phase gets when the run_vc phase draws its wavs
          from the same generator first). Each batch runs the step on the
          card as shipped and with one part swapped (cuDNN off; K1-GAN or K2
          by its plain version), in float64 (K1-GAN and K2 plain) and in
          float64 with one fp32 part (K1-GAN's kernel; the generator's
          output y_hat, or the gradient arriving at it, rounded to fp32;
          y_hat's value from the generator run in fp32),
          and on the CPU in fp32 (oneDNN on and off) and float64 (oneDNN
          off). Each run's first
          Adam moments, leaf by leaf, against the CPU's float64 step: the
          largest relative L2 of G and D and the leaves past 1e-3. For the
          card's worst G leaf, each generator loss term's gradient on the
          card against the CPU float64's: its share of the leaf's gradient
          and the error it brings.

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


def step(dev: torch.device, n_seeds: int) -> None:
    import contextlib

    from conan_tpu_torch.checkpoint import tree_leaves, tree_map
    from conan_tpu_torch.config import load_config
    from conan_tpu_torch.ops import conv as conv_mod
    from conan_tpu_torch.ops.precision import precision_scope
    from conan_tpu_torch.train import losses as losses_mod
    from conan_tpu_torch.train.tasks import VocoderTask, _with_grad

    @contextlib.contextmanager
    def swapped(module, name, fn):
        old = getattr(module, name)
        setattr(module, name, fn)
        try:
            yield
        finally:
            setattr(module, name, old)

    def dbl(t):
        return t.double() if t.is_floating_point() else t

    class RoundGrad(torch.autograd.Function):
        """Identity whose backward rounds the incoming gradient to fp32."""
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g.float().to(g.dtype)

    def rounded(apply, where):
        """The generator's apply with its output y_hat ("output"), or the
        gradient arriving at y_hat ("grad"), rounded to fp32, or with y_hat's
        value from the generator run in fp32 ("fp32 forward")."""
        def fn(params, mel):
            y = apply(params, mel)
            if where == "grad":
                return RoundGrad.apply(y)
            if where == "output":
                return y + (y.float().to(y.dtype) - y).detach()
            with torch.no_grad():
                y32 = apply(tree_map(lambda t: t.float(), params), mel.float())
            return y + (y32.to(y.dtype) - y).detach()
        return fn

    def k1_in_fp32(wav, cfg):
        return logmel_gan(wav.float(), cfg).to(wav.dtype)

    def moments(state):
        return {opt: tree_leaves(state[opt]["mu"]) for opt in ("opt_g", "opt_d")}

    def term_grads(task, state, small, leaf):
        with precision_scope(task.precision, task.device):
            pg = _with_grad(state["params_g"])
            _, terms, _ = task._gen_losses(pg, state["params_d"], small["mels"], small["wavs"])
            w = tree_leaves(pg)[leaf]
            return {k: torch.autograd.grad(v, w, retain_graph=True)[0].cpu().double()
                    for k, v in terms.items()}

    hp = load_config(os.path.join(ROOT, "egs", "soak_r5", "vocoder.yaml"))
    hp.update(train_precision="highest")
    task, task_cpu = VocoderTask(hp), VocoderTask(hp, device="cpu")

    def plain_k1_cm():
        return swapped(losses_mod, "logmel_gan", logmel_gan_reference)

    def plain_k2_cm():
        return swapped(conv_mod, "groupconv", grouped_conv1d_reference)
    cases = [(f"seed {s}", s, ()) for s in range(n_seeds)]
    cases.insert(1, ("seed 0 after the run_vc draws", 0, (3.3, 2.0, 1.7, 2.9, 4.0)))
    for label, seed, extra in cases:
        rng = np.random.default_rng(seed)
        for sec in (5.12, 2.56, *extra):
            cs.synth_wav(rng, sec)
        small = {k: v[:cs.CHECK_B] for k, v in cs.train_batch(hp, rng, dev).items()}
        small_cpu = {k: v.cpu() for k, v in small.items()}
        state0 = task.init_state(torch.Generator().manual_seed(seed + 1))
        state_cpu = tree_map(lambda t: t.cpu(), state0)
        state64, small64 = tree_map(dbl, state0), {k: dbl(v) for k, v in small.items()}
        runs = {"card": moments(task.train_step(state0, small)[0])}
        with torch.backends.cudnn.flags(enabled=False):
            runs["card, cuDNN off"] = moments(task.train_step(state0, small)[0])
        with plain_k1_cm():
            runs["card, K1-GAN plain"] = moments(task.train_step(state0, small)[0])
        with plain_k2_cm():
            runs["card, K2 plain"] = moments(task.train_step(state0, small)[0])
        with plain_k2_cm():
            with plain_k1_cm():
                runs["card float64"] = moments(task.train_step(state64, small64)[0])
            # one fp32 part at a time in the float64 step
            with swapped(losses_mod, "logmel_gan", k1_in_fp32):
                runs["card float64, K1-GAN (kernel) in fp32"] = moments(
                    task.train_step(state64, small64)[0])
            with plain_k1_cm():
                for where in ("output", "grad", "fp32 forward"):
                    with swapped(task.gen, "apply", rounded(task.gen.apply, where)):
                        runs[f"card float64, y_hat's {where}"] = moments(
                            task.train_step(state64, small64)[0])
        runs["CPU fp32, oneDNN on"] = moments(task_cpu.train_step(state_cpu, small_cpu)[0])
        with torch.backends.mkldnn.flags(enabled=False):
            runs["CPU fp32"] = moments(task_cpu.train_step(state_cpu, small_cpu)[0])
            runs["CPU float64"] = moments(task_cpu.train_step(
                tree_map(dbl, state_cpu), {k: dbl(v) for k, v in small_cpu.items()})[0])
        ref = runs["CPU float64"]
        worst_card = 0
        for name, mu in runs.items():
            errs = {opt: [cs.rel_l2(a.cpu(), b) for a, b in zip(mu[opt], ref[opt])]
                    for opt in mu}
            worst = {opt: max(range(len(e)), key=e.__getitem__) for opt, e in errs.items()}
            past = [f"{opt[-1].upper()}{i} {e:.3g}" for opt in errs
                    for i, e in enumerate(errs[opt]) if e > cs.STEP_GRAD_REL]
            worst_card = worst["opt_g"] if name == "card" else worst_card
            print(f"step {label}: {name} vs CPU float64: G max {errs['opt_g'][worst['opt_g']]:.3g} "
                  f"(leaf {worst['opt_g']}), D max {errs['opt_d'][worst['opt_d']]:.3g} (leaf "
                  f"{worst['opt_d']}), G leaf 72 {errs['opt_g'][72]:.3g}; past "
                  f"{cs.STEP_GRAD_REL}: {past or 'none'}", flush=True)
        with torch.backends.mkldnn.flags(enabled=False):
            want = term_grads(task_cpu, tree_map(dbl, state_cpu),
                              {k: dbl(v) for k, v in small_cpu.items()}, worst_card)
        got = term_grads(task, state0, small, worst_card)
        total = sum(want.values()).norm()
        print(f"step {label}: card's worst G leaf {worst_card}, by generator loss term: "
              + "; ".join(f"{k} share {float(want[k].norm() / total):.3g}, error "
                          f"{float((got[k] - want[k]).norm() / total):.3g}" for k in want),
              flush=True)


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] not in ("accuracy", "sweep", "step"):
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
    elif sys.argv[1] == "step":
        step(dev, int(sys.argv[2]) if len(sys.argv) > 2 else 6)
    else:
        sweep(dev, json.loads(sys.argv[2]) if len(sys.argv) > 2 else {})


if __name__ == "__main__":
    main()
