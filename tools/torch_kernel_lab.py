#!/usr/bin/env python3
"""Measurements of the PyTorch port's two CUDA kernels on one card, beside
chip_smoke.py, which checks and times them as they ship.

    python3 tools/torch_kernel_lab.py accuracy
    python3 tools/torch_kernel_lab.py sweep '{"name": {"B": "256, 32, 32, 32, 32, 2"}, ...}'
    python3 tools/torch_kernel_lab.py step [N]
    python3 tools/torch_kernel_lab.py bf16 [--sweep] [PARENT_DIR]
    python3 tools/torch_kernel_lab.py bwd [PARENT_DIR]
    python3 tools/torch_kernel_lab.py profile DIR [DIR ...] [--variants V,..]

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
bf16      K2-bf16 on the 15 MSD grouped geometries at B=18, T=8000 (and the
          card tests' ragged ones), each against its plain version (atol
          2e-4, rtol 1e-4) and timed as bare launches by CUDA events
          (chip_smoke.py:groupconv_bf16_launch_ms), beside the wrapper call
          and cuDNN's bf16 F.conv1d (CUDA events): the shipped tiles, run
          twice between two runs of the kernel in PARENT_DIR/conan_tpu_torch/
          csrc/groupconv.cu (a `git archive` of the commit before, through
          the same C entry points), when given; with --sweep, also every
          tile of csrc/groupconv.cu's K2BF16_SWEPT list, built with
          -DK2BF16_SWEEP into build/kernel_lab/ (and -DK2BF16_WATCHDOG: a
          pipeline that deadlocks traps). Writes its rows to
          build/kernel_lab/k2bf16_lab.json.
bwd       K2-bf16's backward, dx and dw, on the 15 MSD grouped geometries
          at B=18, T=8000: the shipped library built as native.build does
          (the ptxas notes that serialize or wait on wgmma counted by
          source), each kernel (and the forward) against its plain version
          (relative L2 at most chip_smoke.py's BF16_KERNEL_GRAD_REL), timed
          as bare launches by CUDA events and by torch.profiler (device ms)
          and dx and dw as wrapper calls, beside cuDNN's bf16 conv1d_input /
          conv1d_weight and the bound; dw's plan swept here, not in the
          program: 1 or 2 consumer warpgroups a block, splits planned for
          half and all of the card's SMs. With PARENT_DIR (a `git archive`
          of the commit before, under chiprun_archive/), each tree's
          forward, dx and dw as `profile`'s "full" rows (bare and device ms,
          the parent's dw both its launches), each tree in a child process
          of its own (two kernel libraries loaded in one process disturbed
          each other's results), parent, change, change, parent. Writes its
          rows to build/kernel_lab/k2bf16_bwd_lab.json.
profile   Step 0 of a redesign: python3 tools/torch_kernel_lab.py profile
          DIR [DIR ...] [--variants full,loads,mma,round,reduce]. Each
          tree's kernel library built with its K2-bf16 sources patched
          (probe_source: "loads" without the wgmma statements, "mma"
          without the TMA loads, "round" without dw's rounding pass,
          "reduce" without dw's own launch, leaving a reduction launch where
          the source has one) into build/kernel_lab/, then that tree's
          chip_smoke.py bare launches of the forward, dx and dw (and, for
          "full", their relative L2 and the wrapper's device ms by kernel)
          on the 15 geometries, in a child process of the tree.

Imports nothing of JAX or conan_tpu.
"""

from __future__ import annotations

import contextlib
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
from conan_tpu_torch.ops import groupconv as gc  # noqa: E402
from conan_tpu_torch.ops.groupconv import (GroupConvKernel, bf16_plan,  # noqa: E402
                                           grouped_conv1d_bf16_input_grad_reference,
                                           grouped_conv1d_bf16_reference,
                                           grouped_conv1d_bf16_weight_grad_reference,
                                           grouped_conv1d_reference, groupconv, kernel_weights)
from conan_tpu_torch.ops.logmel import logmel_gan, logmel_gan_reference  # noqa: E402
from conan_tpu_torch.ops.precision import training_scope  # noqa: E402
from conan_tpu_torch.train.losses import gan_mel_configs  # noqa: E402

MSD_LAYERS = [(128, 128, 2, 4), (128, 256, 2, 16), (256, 512, 4, 16), (512, 1024, 4, 16),
              (1024, 1024, 1, 16)]   # (ci, co, stride, groups), k 41, padding 20
CLASSES = "ABCD"                     # groupconv_forward's launch<...> lines, in order


@contextlib.contextmanager
def swapped(module, name, value):
    """``module.name`` set to ``value`` for the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


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
    from conan_tpu_torch.checkpoint import tree_leaves, tree_map
    from conan_tpu_torch.config import load_config
    from conan_tpu_torch.ops import conv as conv_mod
    from conan_tpu_torch.ops.precision import precision_scope
    from conan_tpu_torch.train import losses as losses_mod
    from conan_tpu_torch.train.tasks import VocoderTask, _with_grad

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


def _build(name: str, source: str, extra: list[str]) -> ctypes.CDLL | None:
    """One source built alone into build/kernel_lab/<name>.so; None when
    nvcc fails (its log printed)."""
    out_dir = os.path.join(ROOT, "build", "kernel_lab")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.so")
    proc = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, *extra, "-I",
                           os.path.dirname(source), source, "-o", path],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", proc.stdout))
    serial = len(re.findall(r"wgmma.mma_async instructions are serialized", proc.stdout))
    print(f"{name}: nvcc rc {proc.returncode}, registers "
          f"{re.findall(r'Used (\d+) registers', proc.stdout)}, spill bytes {spills}, "
          f"wgmma serialization warnings {serial}", flush=True)
    if proc.returncode:
        print(proc.stdout[-6000:], flush=True)
        return None
    if serial:
        print("\n".join(line for line in proc.stdout.splitlines() if "wgmma" in line)[:4000])
    return ctypes.CDLL(path)


def bf16(dev: torch.device, parent: str | None, do_sweep: bool) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    src = os.path.join(ROOT, "conan_tpu_torch", "csrc", "groupconv.cu")
    text = open(src).read()
    tile_re = r"X\((\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\)"

    def tiles_of(block: str) -> list[tuple]:
        body = text[text.index(f"#define {block}(X)"):]
        body = body[:body.index("\n\n")]
        return [tuple(map(int, m)) for m in re.findall(tile_re, body)]

    shipped, swept = tiles_of("K2BF16_SHIPPED"), tiles_of("K2BF16_SWEPT") if do_sweep else []
    lib = _build("k2bf16_sweep", src,
                 ["-DK2BF16_WATCHDOG", *(["-DK2BF16_SWEEP"] if do_sweep else [])])
    if lib is None:
        raise SystemExit("bf16: the K2-bf16 source does not build")
    geometry_plan = [I] * 16
    lib.groupconv_bf16_weights.argtypes = [P, P, I, I, I, P]
    lib.groupconv_bf16_describe.argtypes = [P, P, I, I, I, I, I, I, I, P]
    lib.groupconv_bf16_conv.argtypes = [P, P, *geometry_plan, P]
    old = _parent_lib(parent)

    gen = torch.Generator().manual_seed(0)
    cases = [(f"scale {sc}", cs.TRAIN_B, t, ci, co, k, s, g, pd)
             for sc, t, ci, co, k, s, g, pd in cs.msd_grouped_geometries(8000)]
    cases += [("ragged", 3, 13, 128, 128, 41, 2, 4, 20), ("ragged", 1, 121, 1024, 1024, 41, 1, 16, 20),
              ("ragged", 5, 993, 256, 512, 41, 4, 16, 20), ("ragged", 7, 1, 512, 1024, 41, 4, 16, 20),
              ("ragged", 2, 497, 128, 256, 41, 2, 16, 20)]
    rows, sums = [], {}
    for label, B, t, ci, co, k, s, g, pd in cases:
        x = torch.randn(B, t, ci, generator=gen).to(dev)
        w = ((torch.rand(co, ci // g, k, generator=gen) * 2 - 1) * (3 / (k * ci // g)) ** 0.5
             ).to(dev)
        want = grouped_conv1d_bf16_reference(x, w, stride=s, padding=(pd, pd), groups=g)
        T_out = want.shape[1]
        row = {"case": f"{label} {ci}->{co} s{s} g{g} B={B} T={t}"}

        def timed(tiles):
            try:
                ms, y, _ = cs.groupconv_bf16_launch_ms(x, w, s, pd, g, lib=lib, tiles=tiles)
            except (SystemExit, ValueError) as e:
                print(f"  {tiles}: {e}", flush=True)
                return float("inf")
            torch.cuda.synchronize()
            ok = torch.allclose(y, want, atol=2e-4, rtol=1e-4)
            return ms if ok else float("nan")

        def parent_ms():
            ms, y, _ = cs.groupconv_bf16_launch_ms(x, w, s, pd, g, lib=old)
            torch.cuda.synchronize()
            return ms if torch.allclose(y, want, atol=2e-4, rtol=1e-4) else float("nan")

        plan = bf16_plan(B, T_out, ci, co, g, k, s)
        conv = dict(stride=s, padding=(pd, pd), groups=g)
        x_cf, w_b = x.transpose(1, 2).contiguous().bfloat16(), w.bfloat16()
        with torch.no_grad(), training_scope("default", dev):
            row["wrapper"] = cs.cuda_ms(lambda: groupconv(x, w, **conv))
            row["cuDNN bf16"] = cs.cuda_ms(lambda: F.conv1d(x_cf, w_b, stride=s, padding=pd,
                                                            groups=g))
        order = ["parent", "shipped", "shipped", "parent"] if old else ["shipped", "shipped"]
        got = {}
        for name in order:
            got.setdefault(name, []).append(parent_ms() if name == "parent" else timed(None))
        for name, v in got.items():
            row[name] = v
        cigp, cog = -(-(ci // g) // 16) * 16, co // g
        for tiles in swept:
            if tiles[1] == cigp and cog % tiles[0] == 0:
                row[str(tiles)] = timed((tiles[0], *tiles[2:]))
        row["plan"] = plan._asdict()
        rows.append(row)
        print(row["case"] + f" (tiles {plan.args}): " + " | ".join(
            f"{n} {' / '.join(f'{v:.4f}' for v in (vs if isinstance(vs, list) else [vs]))}"
            for n, vs in row.items() if n not in ("case", "plan")), flush=True)
        if label.startswith("scale"):
            for n, vs in row.items():
                if n not in ("case", "plan"):
                    sums[n] = sums.get(n, 0.0) + (min(vs) if isinstance(vs, list) else vs)
    print("sums over the 15 MSD geometries (ms a launch, the better of each pair; nan: wrong, "
          "inf: refused): " + " | ".join(f"{n} {v:.4f}" for n, v in sums.items()), flush=True)
    with open(os.path.join(ROOT, "build", "kernel_lab", "k2bf16_lab.json"), "w") as f:
        json.dump({"rows": rows, "sums": sums}, f, indent=1, default=str)


def _parent_lib(parent: str | None) -> ctypes.CDLL | None:
    """K2-bf16's forward entry points from PARENT_DIR's groupconv.cu, built
    alone (None without a parent)."""
    if not parent:
        return None
    P, I = ctypes.c_void_p, ctypes.c_int
    old = _build("k2bf16_parent", os.path.join(parent, "conan_tpu_torch", "csrc",
                                               "groupconv.cu"), [])
    if old is None:
        raise SystemExit("the parent's groupconv.cu does not build")
    old.groupconv_bf16_weights.argtypes = [P, P, I, I, I, P]
    old.groupconv_bf16_describe.argtypes = [P, P, I, I, I, I, I, I, I, P]
    old.groupconv_bf16_conv.argtypes = [P, P, *[I] * 16, P]
    return old


def bwd(dev: torch.device, parent: str | None, sweep_plans: bool = True) -> None:
    log = native.build(force=True)
    notes = {"serialized": r"wgmma.mma_async instructions are serialized",
             "wait injected": r"warpgroup.wait is injected",
             "arrive injected": r"warpgroup.arrive is injected"}
    for src in native.SOURCES:
        lines = [ln for ln in log.splitlines() if f"_{src.stem}_cu_" in ln]
        print(f"{src.name}: " + ", ".join(f"{k} {sum(bool(re.search(v, ln)) for ln in lines)}"
                                          for k, v in notes.items()), flush=True)
        for ln in [ln for ln in lines if any(re.search(v, ln) for v in notes.values())][:3]:
            print("  " + ln[:240], flush=True)
    entry = None
    for ln in log.splitlines():     # registers and spills of K2-bf16 dw's kernels
        if "Compiling entry function" in ln:
            entry = ln if "k2bf16_wgrad" in ln else None
        elif entry and ("registers" in ln or "spill" in ln):
            print(f"  {entry.split(chr(39))[1][-60:]}: {ln.strip()}", flush=True)
    native.load()
    # the parent and this tree, each in a child process of its own (two
    # kernel libraries in one process disturbed each other's results):
    # bare and device ms, parent, change, change, parent
    timed = {}
    if parent:
        libs = {"parent": build_variant(parent, "parent", "full"),
                "change": build_variant(ROOT, "change", "full")}
        roots = {"parent": parent, "change": ROOT}
        for name in ("parent", "change", "change", "parent"):
            res = subprocess.run([sys.executable, "-c", PROFILE_CODE,
                                  os.path.abspath(roots[name]), libs[name], "full"],
                                 capture_output=True, text=True)
            if res.returncode:
                raise SystemExit(f"bwd: the {name} run failed:\n" + res.stdout[-2000:]
                                 + res.stderr[-2000:])
            for i, r in enumerate(json.loads(res.stdout.strip().splitlines()[-1])):
                row = timed.setdefault(i, {})
                for key, v in r.items():
                    if key == "case":
                        continue
                    label = f"{name} {key}"
                    if "rel" in key:
                        row[label] = max(row.get(label, 0.0), v)
                    elif v is not None:
                        row[label] = min(row.get(label, float("inf")), v)
    kernel = GroupConvKernel()
    sms = gc.sm_count(dev.index or 0)
    gen = torch.Generator().manual_seed(0)
    rows, sums = [], {}
    for i, (sc, t, ci, co, k, s, g, pd) in enumerate(cs.msd_grouped_geometries(8000)):
        B = cs.TRAIN_B
        T_out = (t + 2 * pd - k) // s + 1
        x = torch.randn(B, t, ci, generator=gen).to(dev)
        w = ((torch.rand(co, ci // g, k, generator=gen) * 2 - 1) * (3 / (k * ci // g)) ** 0.5
             ).to(dev)
        gy = torch.randn(B, T_out, co, generator=gen).to(dev)
        conv = dict(stride=s, padding=(pd, pd), groups=g)
        want_dx = grouped_conv1d_bf16_input_grad_reference(gy, w, x.shape, **conv)
        want_dw = grouped_conv1d_bf16_weight_grad_reference(x, gy, w.shape, **conv)
        row = {"case": f"scale {sc} {ci}->{co} s{s} g{g} B={B} T={t}", **timed.get(i, {})}

        def checked(ms, got, want):
            ok = cs.rel_l2(got, want) <= cs.BF16_KERNEL_GRAD_REL
            return ms if ok else float("nan")

        row["dx"] = checked(*cs.groupconv_bf16_dx_launch_ms(gy, w, x.shape, s, pd, g)[:2],
                            want_dx)
        row["dw"] = checked(*cs.groupconv_bf16_dw_launch_ms(x, gy, w.shape, s, pd, g), want_dw)
        with torch.no_grad():
            row["dx wrapper"] = cs.cuda_ms(lambda: kernel.input_grad_bf16(gy, w, x.shape, **conv))
            row["dw wrapper"] = cs.cuda_ms(lambda: kernel.weight_grad_bf16(x, gy, w.shape,
                                                                           **conv))
        if sweep_plans:
            # dw's plan swept here, not in the program: the consumer
            # warpgroups a block fixed at 1 or 2, the splits planned for
            # half and all of this card's SMs
            for nwg, n_sms in ((n, m) for n in range(1, gc.WGRAD_MAX_WARPGROUPS + 1)
                               for m in (sms // 2, sms)):
                try:
                    with swapped(gc, "WGRAD_WARPGROUPS", (nwg,)):
                        plan = gc.bf16_wgrad_plan.__wrapped__(B, T_out, ci, co, g, k, s, n_sms)
                except ValueError:
                    continue
                if plan.nwg != nwg:
                    continue
                row[f"dw {nwg} wg, {n_sms} SMs ({plan.n_tiles}x{plan.splits})"] = checked(
                    *cs.groupconv_bf16_dw_launch_ms(x, gy, w.shape, s, pd, g, plan=plan),
                    want_dw)
        xp = F.pad(x.transpose(1, 2), (pd, pd)).bfloat16()
        gyb, wb = gy.transpose(1, 2).bfloat16(), w.bfloat16()
        row["cuDNN bf16 dx"] = cs.cuda_ms(lambda: torch.nn.grad.conv1d_input(
            xp.shape, wb, gyb, stride=s, groups=g), iters=10)
        row["cuDNN bf16 dw"] = cs.cuda_ms(lambda: torch.nn.grad.conv1d_weight(
            xp, w.shape, gyb, stride=s, groups=g), iters=10)
        row["bound"] = cs.groupconv_bf16_bound_ms(B, t, ci, co, k, s, g, pd)[0]
        row["dw plan"] = gc.bf16_wgrad_plan(B, T_out, ci, co, g, k, s, sms)._asdict()
        rows.append(row)
        print(row["case"] + ": " + " | ".join(
            f"{n} {v:.4f}" if "rel" not in n else f"{n} {v:.3g}"
            for n, v in row.items() if isinstance(v, float)) + f" | dw plan {row['dw plan']}",
            flush=True)
        for n, v in row.items():
            if isinstance(v, float) and "rel" not in n:
                sums[n] = sums.get(n, 0.0) + v
    slower = [r["case"] for r in rows
              if r.get("change dw device", r["dw"]) > r["cuDNN bf16 dw"]]
    print("sums over the 15 MSD geometries (ms; each the better of its pair; nan: wrong): "
          + " | ".join(f"{n} {v:.4f}" for n, v in sums.items()), flush=True)
    print(f"geometries where dw's device ms exceeds cuDNN bf16 conv1d_weight's: {slower}",
          flush=True)
    os.makedirs(os.path.join(ROOT, "build", "kernel_lab"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "kernel_lab", "k2bf16_bwd_lab.json"), "w") as f:
        json.dump({"rows": rows, "sums": sums}, f, indent=1, default=str)


PROFILE_VARIANTS = ("full", "loads", "mma", "round", "reduce")


def probe_source(name: str, text: str, variant: str) -> str:
    """A K2-bf16 source (``name``: groupconv.cu or groupconv_bwd.cu) as the
    probe ``variant`` builds it: "loads" no wgmma statement; "mma" no TMA
    load, each barrier expecting no bytes; "round" (dw) the weight
    gradient kernel's loops over `e` (its rounding of the staged chunk into
    bf16 tiles) run no iteration; "reduce" (dw) the weight gradient
    kernel's own launch (`kernel<<<`) taken out, so that only what else the
    entry launches runs (a reduction launch, where the source has one)."""
    if variant == "loads":
        return re.sub(r"Wgmma(RS)?<[^;]*;", ";", text, flags=re.S)
    if variant == "mma":
        text = re.sub(r"tma_load_[23]d\([^;]*;", ";", text, flags=re.S)
        return re.sub(r"mbar_expect_tx\(([^,;]+),[^;]*;", r"mbar_expect_tx(\1, 0);", text,
                      flags=re.S)
    if name != "groupconv_bwd.cu":
        return text
    if variant == "round":
        head, body = text.split("k2bf16_wgrad_kernel(", 1)
        end = body.index("\n}\n")
        return (head + "k2bf16_wgrad_kernel(" +
                re.sub(r"(for \(int e = [^;]*; e <)[^;]*;", r"\1 0;", body[:end]) + body[end:])
    if variant == "reduce":
        return re.sub(r"\n\s*kernel<<<[^;]*;", "\n", text, flags=re.S)
    return text


def build_variant(root: str, label: str, variant: str) -> str:
    """The port's kernel library of the tree at ``root``, its K2-bf16
    sources patched by probe_source, built as ops/native.build does into
    build/kernel_lab/<label>-<variant>/; returns the library's path."""
    import shutil

    out = os.path.join(ROOT, "build", "kernel_lab", f"{label}-{variant}")
    shutil.rmtree(out, ignore_errors=True)
    csrc = os.path.join(out, "csrc")
    shutil.copytree(os.path.join(root, "conan_tpu_torch", "csrc"), csrc)
    for name in ("groupconv.cu", "groupconv_bwd.cu"):
        path = os.path.join(csrc, name)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(probe_source(name, text, variant))
    srcs = sorted(n for n in os.listdir(csrc) if n.endswith(".cu"))
    nvcc = native._nvcc()
    procs = [subprocess.Popen([nvcc, *native.COMPILE_FLAGS, os.path.join(csrc, n), "-o",
                               os.path.join(out, n + ".o")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for n in srcs]
    logs = [p.communicate()[0] for p in procs]
    lib = os.path.join(out, "libconan_kernels.so")
    if any(p.returncode for p in procs) or subprocess.run(
            [nvcc, *native.NVCC_FLAGS, *[os.path.join(out, n + ".o") for n in srcs], "-o", lib],
            capture_output=True).returncode:
        raise SystemExit(f"profile: {label} {variant} did not build:\n" + "".join(logs)[-4000:])
    fn = ""
    for line in "".join(logs).splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = line.split("'")[1] if "'" in line else line.split()[-1]
        elif "groupconv" in fn and ("Used" in line or "spill" in line) \
                or "C75" in line:
            print(f"ptxas {label} {variant} {fn[:70]}:", line.strip()[:150], flush=True)
    return lib


# run in a child process whose first sys.path entry is the tree to time:
# argv[2] the library to load in place of the tree's own, argv[3] "full"
# where the checks hold (and the kernels' device ms are taken), else a probe
PROFILE_CODE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from pathlib import Path
import torch
import chip_smoke as cs
from conan_tpu_torch.ops import native
from conan_tpu_torch.ops.groupconv import (GroupConvKernel,
    grouped_conv1d_bf16_input_grad_reference as ref_dx,
    grouped_conv1d_bf16_weight_grad_reference as ref_dw)
native.LIB_PATH = Path(sys.argv[2])
native.load()
full = sys.argv[3] == "full"
if not full:
    def fail(msg):
        print("probe, not checked:", msg[:120], file=sys.stderr)
    cs.fail = fail
src = (Path(sys.argv[1]) / "conan_tpu_torch" / "csrc" / "groupconv_bwd.cu").read_text()
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(0)
kernel = GroupConvKernel()
out = []
for sc, t, ci, co, k, s, g, pd in cs.msd_grouped_geometries(8000):
    B = cs.TRAIN_B
    T_out = (t + 2 * pd - k) // s + 1
    x = torch.randn(B, t, ci, generator=gen).to(dev)
    w = ((torch.rand(co, ci // g, k, generator=gen) * 2 - 1) * (3 / (k * ci // g)) ** 0.5).to(dev)
    gy = torch.randn(B, T_out, co, generator=gen).to(dev)
    conv = dict(stride=s, padding=(pd, pd), groups=g)
    row = {"case": f"scale {sc} {ci}->{co} s{s} g{g}"}
    row["fwd"] = cs.groupconv_bf16_launch_ms(x, w, s, pd, g)[0]
    row["dx"], dx = cs.groupconv_bf16_dx_launch_ms(gy, w, x.shape, s, pd, g)[:2]
    row["dw"], dw = cs.groupconv_bf16_dw_launch_ms(x, gy, w.shape, s, pd, g)[:2]
    if full:
        row["dx rel"] = cs.rel_l2(dx, ref_dx(gy, w, x.shape, **conv))
        row["dw rel"] = cs.rel_l2(dw, ref_dw(x, gy, w.shape, **conv))
        fns = {"dx": lambda: kernel.input_grad_bf16(gy, w, x.shape, **conv),
               "dw": lambda: kernel.weight_grad_bf16(x, gy, w.shape, **conv)}
        keys = {"dx device": ("dx", "groupconv_bf16_dx_kernel" if "groupconv_bf16_dx_kernel"
                              in (Path(sys.argv[1]) / "conan_tpu_torch" / "csrc" /
                                  "groupconv.cu").read_text() else "groupconv_bf16_kernel"),
                "dw device": ("dw", "k2bf16_wgrad_kernel")}
        if "k2bf16_wgrad_reduce_kernel" in src:
            keys["dw reduce device"] = ("dw", "k2bf16_wgrad_reduce_kernel")
        for name, (which, key) in keys.items():
            row[name] = cs.kernel_device_ms(fns[which], key)
    out.append(row)
print(json.dumps(out))
"""


def profile(roots: list[str], variants=PROFILE_VARIANTS) -> None:
    """Step 0 of a redesign: each tree's K2-bf16 dx and dw (and forward)
    bare ms on the 15 MSD geometries at B=18, with each probe variant of
    its sources (probe_source), in a child process of that tree."""
    libs = {(root, v): build_variant(root, f"tree{i}", v)
            for i, root in enumerate(roots) for v in variants}
    sums = {}
    for root in roots:
        for v in variants:
            res = subprocess.run([sys.executable, "-c", PROFILE_CODE, os.path.abspath(root),
                                  libs[root, v], v], capture_output=True, text=True)
            if res.returncode:
                print(f"profile {root} {v} failed:\n" + res.stdout[-2000:] + res.stderr[-2000:],
                      flush=True)
                continue
            for r in json.loads(res.stdout.strip().splitlines()[-1]):
                print(f"profile {root} {v}: {r['case']}: " + " | ".join(
                    f"{n} {cs.ms_text(x) if 'rel' not in n else f'{x:.3g}'}"
                    for n, x in r.items() if n != "case"), flush=True)
                for n, x in r.items():
                    if n != "case" and "rel" not in n:
                        key = f"{root} {v} {n}"
                        sums[key] = None if x is None or sums.get(key, 0.0) is None \
                            else sums.get(key, 0.0) + x
    for key, x in sums.items():
        print(f"profile sum over the 15 geometries: {key} {cs.ms_text(x)} ms", flush=True)


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "profile":
        args = sys.argv[2:]
        kw = {}
        if "--variants" in args:
            i = args.index("--variants")
            kw["variants"] = tuple(args[i + 1].split(","))
            args = args[:i] + args[i + 2:]
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        profile(args, **kw)
        return
    if len(sys.argv) < 2 or sys.argv[1] not in ("accuracy", "sweep", "step", "bf16", "bwd"):
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
    elif sys.argv[1] == "bwd":
        bwd(dev, sys.argv[2] if len(sys.argv) > 2 else None)
    elif sys.argv[1] == "bf16":
        args = [a for a in sys.argv[2:] if a != "--sweep"]
        bf16(dev, args[0] if args else None, "--sweep" in sys.argv[2:])
    else:
        sweep(dev, json.loads(sys.argv[2]) if len(sys.argv) > 2 else {})


if __name__ == "__main__":
    main()
