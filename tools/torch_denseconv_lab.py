#!/usr/bin/env python3
"""Measurements of the dense 1-D convolutions of the PyTorch port's training
steps on one card, beside chip_smoke.py, which checks and times them as they
ship.

    python3 tools/torch_denseconv_lab.py step0 [--tasks conan,vocoder,postnet]
    python3 tools/torch_denseconv_lab.py leaf [SEED]
    python3 tools/torch_denseconv_lab.py k3 [--watchdog]
    python3 tools/torch_denseconv_lab.py route PARENT_DIR
    python3 tools/torch_denseconv_lab.py host PARENT_DIR
    python3 tools/torch_denseconv_lab.py profile DIR [DIR ...] [--variants V,..] [--k3] [--watchdog]
    python3 tools/torch_denseconv_lab.py compare PARENT_DIR
    python3 tools/torch_denseconv_lab.py sweep

step0  each training task's step at its chip_smoke.py shape (Conan and the
       postnet B=24 x 1496 frames of synthesized features, the vocoder
       B=18 x 8000 samples of synthesized wavs), random weights, at the
       "default" and the "highest" rung: every dense conv1d call of the step
       (groups 1), its geometry (B, T, Ci, Co, K, dilation, padding) and how
       often the step makes it, recorded through the port's ops.conv.conv1d;
       then one step under torch.profiler with shapes recorded, and for each
       geometry the CUDA kernels launched under its aten::convolution
       (forward) and aten::convolution_backward (dx and dw), with their
       counts and device ms. One JSON line a task and rung, also written to
       build/denseconv_lab/denseconv_step0.json.
leaf   chip_smoke.py's vocoder_options check step (egs/hifigan_shuffle.yaml
       with the conditional MPD and MSD, the spectrogram discriminator and
       feature matching, "highest", B=2), on the batch the phase draws after
       the train phase's (seed SEED, default 0): each gradient leaf of the
       card's step against the CPU's float64 step, with cuDNN as shipped,
       with cuDNN's deterministic algorithms, and with cuDNN off for conv2d
       alone; then one card step under torch.profiler with shapes recorded:
       the kernels under the ops that touch opt_d leaves 1 and 4 (the mel
       upsampler's [80, 1, 640] weight, a matmul, and the first conditional
       MPD layer's [32, 2, 5, 1] conv2d).
k3     chip_smoke.py's denseconv_row on K3_GEOMETRIES: K3, its dx and its
       dw against their plain versions in float64 beside the parent's
       route (cuDNN's bf16 conv cast to fp32), their times beside cuDNN's
       bf16 and fp32 convs; the library built as native.build does, the
       ptxas report of csrc/denseconv*.cu printed (with --watchdog,
       -DK2BF16_WATCHDOG: a pipeline that deadlocks traps instead of
       hanging).
route  the card tests' "default" cases (tests/test_torch_cuda.py: the
       dense conv1d's DENSE_CASES and three rounded_dot ones; CONV2D_CASES,
       TRANSPOSED_CASES and DOT_CASES) under training_scope("default"),
       once with the package of PARENT_DIR (a `git archive` of an earlier
       commit) and once with this tree's, each in its own process: the
       value and the gradients against the float64 op on the rounded
       operands (relative L2), as the card tests hold them. The dots go
       through nn.blocks.dense (the "dense" case) or the precision module's
       dot entry points, whichever API the tree has.
host   the vocoder's training step (egs/soak_r5/vocoder.yaml, chip_smoke.py's
       B=18 x 8000 batch, random weights), HOST_ORDER's processes:
       "parent" the package of PARENT_DIR, "change" this tree's. Each
       times HOST_STEPS steps at "highest", then at "default" (wall per
       step, synchronized): a parent process its own route, a change
       process HOST_VARIANTS of the MPD's and the window discriminators'
       conv2d, a step each in turn: "fold" as shipped (K3 over the fold in
       one autograd Function, rounded_dot for what K3 refuses), "fold0"
       the same fold composed of autograd ops around ops.conv.conv1d,
       "rounded" rounded_dot alone (fp32 cuDNN on the rounded operands,
       TF32 off), "bf16" the parent's route (cuDNN's bf16 conv cast to
       fp32). Then one step of each under torch.profiler (CPU and CUDA):
       device ms, kernels, K3 launches, the ops with the most host time of
       their own. Last, each variant's steps over all processes: median,
       quartiles, and the change's variants minus "rounded" in the same
       round.
profile  K3's kernels of each DIR (a `git archive` of a commit, or "." for
       this tree) on PROFILE_GEOMETRIES, each built three ways from its
       csrc/ into build/denseconv_lab/: as it is ("full"), with every wgmma
       statement taken out ("loads": the TMA loads, barriers and epilogue
       alone) and with every TMA load taken out and its barrier expecting
       no bytes ("mma": the products on whatever shared memory holds);
       --variants takes a subset, --k3 K3_GEOMETRIES instead. Each
       library runs the tree's own chip_smoke.denseconv_row in a child
       process (the probes' wrong results are reported, not failed on):
       bare-launch ms of fwd, dx and dw, their device ms by the profiler,
       dw's split reduction (the parent's denseconv_wgrad_reduce_kernel)
       apart where the tree has one.
compare  the bare launches of K3, dx and dw (chip_smoke.denseconv_row's
       "bare" ms, and the profiler's device ms) on the 94 geometries of the
       "default" steps (tools/denseconv_geometries.json: recorded by
       chip_smoke.py's recording_convs, with their calls a step), in
       COMPARE_ORDER's processes: "parent" PARENT_DIR's package, "change"
       this tree's. Per geometry each side's mean over its processes, the
       change over the parent; then per task the sums weighted by the calls
       a step, beside the bound.
sweep  bare launches of K3 (fwd, dx) at every tile and stage count and of
       K3 dw at every tiling and split count on SWEEP_GEOMETRIES, the plans'
       choices starred (sweep's docstring).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from conan_tpu_torch.checkpoint import tree_leaves, tree_map  # noqa: E402
from conan_tpu_torch.config import load_config  # noqa: E402
from conan_tpu_torch.ops import native  # noqa: E402
from conan_tpu_torch.train.tasks import ConanTask, VocoderTask  # noqa: E402

OUT = os.path.join(cs.ROOT, "build", "denseconv_lab")


def conan_batch(B: int, T: int, seed: int) -> dict:
    """B synthesized rows of T frames at the r5 width (80 bins), the last
    rows shorter, as chip_smoke.dist_conan_batch makes them."""
    saved = cs.DIST_CONAN_B, cs.DIST_CONAN_T
    cs.DIST_CONAN_B, cs.DIST_CONAN_T = B, T
    try:
        return cs.dist_conan_batch(seed)
    finally:
        cs.DIST_CONAN_B, cs.DIST_CONAN_T = saved


def task_cases(dev: torch.device, tasks: list[str], seed: int):
    """(name, make(rung) → task, state, batch, step kwargs) for each task."""
    from conan_tpu_torch.models.conan.model import Conan, ConanConfig
    from conan_tpu_torch.train.tasks import PostnetTask

    if "conan" in tasks:
        hp = cs.dist_conan_hp(seed)
        task = ConanTask(dict(hp, train_precision="highest"))
        state = task.init_state(torch.Generator().manual_seed(seed + 1))
        batch = conan_batch(cs.CONAN_SPEAKERS * cs.CONAN_UTTS, cs.CONAN_FRAMES[1], seed)
        new, _ = task.host_hook(state, 4, batch)     # the k-means bootstrap of the codebook
        state = new if new is not None else state
        state["step"] = torch.tensor(cs.CONAN_STEPS, dtype=torch.int32, device=dev)
        yield ("conan", lambda rung: ConanTask(dict(hp, train_precision=rung)), state, batch,
               {"use_random_ref": True})
    if "vocoder" in tasks:
        hp = load_config(os.path.join(cs.ROOT, "egs", "soak_r5", "vocoder.yaml"))
        batch = cs.train_batch(hp, np.random.default_rng(seed), dev)
        task = VocoderTask(dict(hp, train_precision="highest"))
        yield ("vocoder", lambda rung: VocoderTask(dict(hp, train_precision=rung)),
               task.init_state(torch.Generator().manual_seed(seed + 1)), batch, {})
    if "postnet" in tasks:
        hp = dict(load_config(os.path.join(cs.ROOT, "egs", "soak_r5", "postnet.yaml")),
                  spec_min=[-8.0] * 80, spec_max=[1.0] * 80)
        gen = torch.Generator().manual_seed(seed + 3)
        conan = Conan(ConanConfig.from_hparams(hp))
        frozen = tree_map(lambda t: t.numpy(), conan.init(gen))
        vq = tree_map(lambda t: t.numpy(), conan.init_vq_state(gen))
        vq["initialized"] = np.ones((), np.float32)
        batch = conan_batch(cs.CONAN_SPEAKERS * cs.CONAN_UTTS, cs.CONAN_FRAMES[1], seed)
        task = PostnetTask(dict(hp, train_precision="highest"), frozen, vq)
        yield ("postnet", lambda rung: PostnetTask(dict(hp, train_precision=rung), frozen, vq),
               task.init_state(torch.Generator().manual_seed(seed + 4)), batch, {})


def step0(dev: torch.device, tasks: list[str], seed: int = 0) -> None:
    rows = []
    for name, make, state, batch, kw in task_cases(dev, tasks, seed):
        for rung in ("default", "highest"):
            task = make(rung)
            gen = torch.Generator(device=dev).manual_seed(seed)
            task.train_step(state, batch, gen, **kw)          # warm
            torch.cuda.synchronize()
            with cs.recording_convs() as seen:
                task.train_step(state, batch, gen, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                task.train_step(state, batch, gen, **kw)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            kernels: dict = {}        # (op, x, w) → {kernel: [count, ms]}, any conf
            for (op, x, w, _conf), ks in cs.conv_kernels(prof).items():
                for name, (count, ms) in ks.items():
                    row = kernels.setdefault((op, x, w), {}).setdefault(name[:140], [0, 0.0])
                    row[0] += count
                    row[1] += ms
            geoms = []
            total_ms = 0.0
            for (B, T, Ci, Co, K, s, d, pl, pr), n in sorted(seen.items()):
                x = (B, Ci, T + pl + pr)
                w = (Co, Ci, K)
                fwd = kernels.get(("aten::convolution", x, w), {})
                bwd = kernels.get(("aten::convolution_backward", x, w), {})
                ms = sum(v[1] for v in fwd.values()) + sum(v[1] for v in bwd.values())
                total_ms += ms
                geoms.append({"B": B, "T": T, "Ci": Ci, "Co": Co, "K": K, "stride": s,
                              "dilation": d, "pad": [pl, pr], "calls": n,
                              "fwd": fwd, "bwd": bwd, "device_ms": ms})
            row = {"task": name, "rung": rung, "geometries": geoms,
                   "dense_conv_device_ms": total_ms, "profiled_wall_s": wall}
            rows.append(row)
            print(json.dumps(row), flush=True)
            print(f"step0 {name} {rung}: {len(geoms)} dense conv1d geometries, "
                  f"{sum(g['calls'] for g in geoms)} calls a step, their cuDNN kernels "
                  f"{total_ms:.3f} device ms in the profiled step", flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "denseconv_step0.json"), "w") as f:
        json.dump(rows, f)


def leaf(dev: torch.device, seed: int) -> None:
    rng = np.random.default_rng(seed)
    cs.train_batch(load_config(os.path.join(cs.ROOT, "egs", "soak_r5", "vocoder.yaml")), rng,
                   dev)                       # the train phase's draw first
    hp = load_config(os.path.join(cs.ROOT, "egs", "hifigan_shuffle.yaml"))
    hp.update(use_cond_disc=True, use_spec_disc=True, use_fm_loss=True,
              accumulate_grad_batches=1, train_precision="highest", seed=seed)
    batch = cs.train_batch(hp, rng, dev)
    small = {k: v[:cs.CHECK_B] for k, v in batch.items()}
    task = VocoderTask(hp)
    state0 = task.init_state(torch.Generator().manual_seed(seed + 2))
    task_cpu = VocoderTask(hp, device="cpu")
    with torch.backends.mkldnn.flags(enabled=False):
        new_64, _ = task_cpu.train_step(
            tree_map(lambda t: t.cpu().double() if t.is_floating_point() else t.cpu(), state0),
            {k: v.cpu().double() for k, v in small.items()})
        new_cpu, _ = task_cpu.train_step(tree_map(lambda t: t.cpu(), state0),
                                         {k: v.cpu() for k, v in small.items()})
    mu64 = tree_leaves(new_64["opt_d"]["mu"])

    def errs(new):
        return [cs.rel_l2(a.cpu(), b) for a, b in zip(tree_leaves(new["opt_d"]["mu"]), mu64)]

    variants = {"cuDNN as shipped": contextlib.nullcontext,
                "cuDNN deterministic": lambda: torch.backends.cudnn.flags(
                    enabled=True, deterministic=True, benchmark=False, allow_tf32=False)}
    out = {"cpu_fp32": errs(new_cpu)}
    for label, ctx in variants.items():
        with ctx():
            new, _ = task.train_step(state0, small)
        torch.cuda.synchronize()
        out[label] = errs(new)
    orig_conv2d = torch.nn.functional.conv2d

    def conv2d_no_cudnn(*a, **k):
        with torch.backends.cudnn.flags(enabled=False):
            return orig_conv2d(*a, **k)

    torch.nn.functional.conv2d = conv2d_no_cudnn
    try:
        new, _ = task.train_step(state0, small)
        torch.cuda.synchronize()
        out["conv2d without cuDNN"] = errs(new)
    finally:
        torch.nn.functional.conv2d = orig_conv2d
    shapes = [tuple(t.shape) for t in mu64]
    for label, e in out.items():
        worst = sorted(range(len(e)), key=lambda i: -e[i])[:4]
        print(f"leaf {label}: opt_d leaf 1 {shapes[1]} {e[1]:.3g}, leaf 4 {shapes[4]} "
              f"{e[4]:.3g}; worst " + ", ".join(f"leaf {i} {shapes[i]} {e[i]:.3g}"
                                                for i in worst), flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        task.train_step(state0, small)
        torch.cuda.synchronize()
    found = collections.defaultdict(collections.Counter)
    for evt in prof.events():
        for k in evt.kernels:
            op = evt
            while op is not None and not op.name.startswith(("aten::convolution", "aten::mm",
                                                             "aten::matmul", "aten::bmm",
                                                             "aten::addmm")):
                op = op.cpu_parent
            if op is None:
                continue
            shapes_op = [tuple(s) for s in op.input_shapes[:3]]
            if any(640 in s or s == (32, 2, 5, 1) or (len(s) == 4 and s[1] == 2)
                   or (len(s) == 3 and s[-1] == 80) for s in shapes_op):
                found[f"{op.name} {shapes_op}"][k.name[:140]] += 1
    for key, ks in found.items():
        print(f"leaf trace: {key}: " + "; ".join(f"{n} x{c}" for n, c in ks.items()), flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "denseconv_leaf.json"), "w") as f:
        json.dump({"errs": out, "shapes": shapes,
                   "trace": {k: dict(v) for k, v in found.items()}}, f)


# (B, T, Ci, Co, K, stride, dilation, pad_l, pad_r): Conan's k=31 and k=5
# convs, its 512 -> 256 k=1, an 80-channel input, the postnet's dilated k=2,
# the vocoder's 32-channel resblock and its 512 -> 2048 upsampler, the MSD's
# 1024 -> 1024, and a ragged small case
K3_GEOMETRIES = [(24, 1496, 256, 512, 31, 1, 1, 15, 15), (24, 1496, 256, 512, 5, 1, 1, 4, 0),
                 (24, 1496, 512, 256, 1, 1, 1, 0, 0), (24, 374, 80, 160, 5, 1, 1, 2, 2),
                 (24, 1496, 256, 512, 2, 1, 8, 8, 0), (18, 8000, 32, 32, 11, 1, 5, 50, 0),
                 (18, 25, 512, 2048, 16, 1, 1, 15, 0), (18, 125, 1024, 1024, 5, 1, 1, 2, 2),
                 (3, 77, 24, 40, 3, 1, 2, 3, 1)]


def k3(dev: torch.device, watchdog: bool) -> None:
    if watchdog:
        native.NVCC_FLAGS.append("-DK2BF16_WATCHDOG")
        native.COMPILE_FLAGS.append("-DK2BF16_WATCHDOG")
    log = native.build(force=True)
    native.load()
    for line in log.splitlines():
        if "denseconv" in line or "spill" in line or "C75" in line:
            print("ptxas:", line.strip()[:200], flush=True)
    gen = torch.Generator().manual_seed(0)
    for g in K3_GEOMETRIES:
        cs.denseconv_row(g, {}, gen, dev)


# run in a child process whose first sys.path entry is the tree to test
ROUTE_CODE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import torch.nn.functional as F
from conan_tpu_torch.ops import conv as conv_ops
from conan_tpu_torch.ops.precision import training_scope
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
rnd = lambda t: t.to(torch.bfloat16).double()
rel = lambda a, b: float((a.detach().double() - b).norm() / b.norm())
out = []
for case in json.loads(sys.argv[2]):
    B, T, Ci, Co, K, d, pl, pr = case
    rng = np.random.default_rng(sum(case))
    x = rng.standard_normal((B, T, Ci))
    w = (rng.random((Co, Ci, K)) * 2 - 1) * np.sqrt(3 / (Ci * K))
    b = 0.1 * rng.standard_normal(Co)
    gy = rng.standard_normal((B, T + pl + pr - d * (K - 1), Co))
    x, w, b, gy = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (x, w, b, gy))
    xx, ww, bb = (t.clone().requires_grad_(True) for t in (x, w, b))
    with training_scope("default", dev):
        y = conv_ops.conv1d(xx, ww, bb, dilation=d, padding=(pl, pr))
        dx, dw, db = torch.autograd.grad(y, (xx, ww, bb), gy)
    xp = F.pad(rnd(x).transpose(1, 2), (pl, pr))
    g = rnd(gy).transpose(1, 2)
    want = (F.conv1d(xp, rnd(w), dilation=d).transpose(1, 2) + b.double(),
            torch.nn.grad.conv1d_input(xp.shape, rnd(w), g, dilation=d)[:, :, pl:pl + T]
            .transpose(1, 2),
            torch.nn.grad.conv1d_weight(xp, w.shape, g, dilation=d), gy.double().sum((0, 1)))
    out.append([case, [rel(a, c) for a, c in zip((y, dx, dw, db), want)]])
print(json.dumps(out))
"""

# the same for conv2d, conv_transpose1d and the dots: argv[2] a JSON list of
# [family, case]
ROUTE_FAMILIES_CODE = r"""
import functools, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import torch.nn.functional as F
from conan_tpu_torch.nn.blocks import dense
from conan_tpu_torch.ops import conv as conv_ops
from conan_tpu_torch.ops import precision
from conan_tpu_torch.ops.precision import training_scope
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
rel = lambda a, b: float((a.detach().double() - b).norm() / b.norm())

def dot(what, a, b):
    if what == "dense":
        return dense(a, b.t())
    if hasattr(precision, "einsum_at_rung"):
        return precision.einsum_at_rung(what, a, b) if "->" in what else precision.dot_at_rung(a, b)
    fn = functools.partial(torch.einsum, what) if "->" in what else torch.matmul
    return precision.dot_at_rung(fn, a, b)

out = []
for family, case in json.loads(sys.argv[2]):
    rng = np.random.default_rng(7)
    if family == "conv2d":
        B, C, H, W, Co, k, s, pad = case
        shapes = [(B, C, H, W), (Co, C, *k), (Co,)]
        rung = lambda x, w, b: conv_ops.conv2d(x, w, b, stride=s, padding=pad)
        plain = lambda x, w: F.conv2d(x, w, stride=s, padding=pad)
        bias = lambda y, b: y + b[:, None, None]
    elif family == "transposed":
        B, T, Ci, Co, K, u, pad, op = case
        shapes = [(B, T, Ci), (Ci, Co, K), (Co,)]
        conv = dict(stride=u, padding=pad, output_padding=op)
        rung = lambda x, w, b: conv_ops.conv_transpose1d(x, w, b, **conv)
        plain = lambda x, w: F.conv_transpose1d(x.transpose(1, 2), w, **conv).transpose(1, 2)
        bias = lambda y, b: y + b
    else:
        what, a_shape, b_shape = case
        shapes = [a_shape, b_shape]
        rung = lambda a, b: dot(what, a, b)
        plain = (lambda a, b: torch.einsum(what, a, b)) if "->" in what else torch.matmul
    ops = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dev)
           / (np.sqrt(np.prod(sh[1:])) if i == 1 else 1) for i, sh in enumerate(shapes)]
    leaves = [t.clone().requires_grad_(True) for t in ops]
    with training_scope("default", dev):
        y = rung(*leaves)
    gy = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32)).to(dev)
    got = [y] + list(torch.autograd.grad(y, leaves, gy))
    r64 = [(t.to(torch.bfloat16) if i < 2 else t).double().requires_grad_(True)
           for i, t in enumerate(ops)]
    y64 = plain(*r64[:2])
    want = [y64.detach() if len(ops) == 2 else bias(y64, r64[2]).detach()]
    want += list(torch.autograd.grad(y64, r64[:2], gy.to(torch.bfloat16).double()))
    if len(ops) > 2:
        want.append(gy.double().sum(tuple(range(gy.dim() - 1)) if family == "transposed"
                                    else (0, 2, 3)))
    out.append([family, case, [rel(a, c) for a, c in zip(got, want)]])
print(json.dumps(out))
"""


def route(parent: str) -> None:
    import importlib.util
    import subprocess

    # by path: the card machine's site-packages may hold another `tests`
    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(cs.ROOT, "tests", "test_torch_cuda.py"))
    card_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card_tests)
    cases = card_tests.DENSE_CASES + [(2, 400, 1, 128, 15, 1, 7, 7), (2, 60, 1024, 1, 3, 1, 1, 1),
                           (2, 300, 32, 1, 7, 1, 6, 0)]
    families = ([["conv2d", c] for c in card_tests.CONV2D_CASES]
                + [["transposed", c] for c in card_tests.TRANSPOSED_CASES]
                + [["dot", c] for c in card_tests.DOT_CASES])
    for label, root in (("parent", os.path.abspath(parent)), ("change", cs.ROOT)):
        res = subprocess.run([sys.executable, "-c", ROUTE_CODE, root, json.dumps(cases)],
                             capture_output=True, text=True, check=True)
        for case, errs in json.loads(res.stdout.strip().splitlines()[-1]):
            print(f"route {label} {case}: relative L2 from float64 y {errs[0]:.3g}, dx "
                  f"{errs[1]:.3g}, dw {errs[2]:.3g}, db {errs[3]:.3g}", flush=True)
        res = subprocess.run([sys.executable, "-c", ROUTE_FAMILIES_CODE, root,
                              json.dumps(families)], capture_output=True, text=True, check=True)
        for family, case, errs in json.loads(res.stdout.strip().splitlines()[-1]):
            print(f"route {label} {family} {case}: relative L2 from float64 "
                  + ", ".join(f"{k} {e:.3g}" for k, e in zip(("y", "d0", "d1", "d2"), errs)),
                  flush=True)


HOST_STEPS = 8          # timed steps at "highest", and a variant's at "default"
HOST_ORDER = ("parent", "change", "change", "parent", "parent", "change")
# a "change" process's variants of the "default" rung's conv2d, taken in
# turn a step each (the order rotating each round)
HOST_VARIANTS = ("fold", "fold0", "rounded", "bf16")
# run in a child process whose first sys.path entry is the tree to time;
# argv[3] "parent" or "change"
HOST_CODE = r"""
import functools, json, os, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import numpy as np, torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from conan_tpu_torch.config import load_config
from conan_tpu_torch.models.vocoder import discriminators
from conan_tpu_torch.ops import conv as conv_ops
from conan_tpu_torch.ops import native, precision
from conan_tpu_torch.train.tasks import VocoderTask
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
native.build()
steps, variants = int(sys.argv[2]), sys.argv[4].split(",")
conv2d = {"fold": discriminators.conv2d}
if sys.argv[3] == "change":
    def pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)

    def fold0(x, w, b=None, *, stride=1, padding=0):
        # the fold composed of autograd ops around conv1d
        if not precision.bf16_dots():
            return F.conv2d(x, w, b, stride=stride, padding=padding)
        f = conv_ops.conv2d_fold(tuple(x.shape), tuple(w.shape), pair(stride), pair(padding))
        y = conv_ops.conv1d(f.x(x), f.w(w), b, dilation=f.Wo)
        return y.reshape(f.B, f.Ho, f.Wo, f.Co).permute(0, 3, 1, 2)

    def rounded(x, w, b=None, *, stride=1, padding=0):
        if not precision.bf16_dots():
            return F.conv2d(x, w, b, stride=stride, padding=padding)
        y = precision.rounded_dot(functools.partial(F.conv2d, stride=stride, padding=padding),
                                  x, w)
        return y if b is None else y + b[:, None, None]

    def bf16(x, w, b=None, *, stride=1, padding=0):
        # the parent's route: cuDNN's bf16 conv, its result cast to fp32
        if not precision.bf16_dots():
            return F.conv2d(x, w, b, stride=stride, padding=padding)
        y = F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), stride=stride,
                     padding=padding).float()
        return y if b is None else y + b[:, None, None]

    conv2d.update(fold0=fold0, rounded=rounded, bf16=bf16)
else:
    variants = ["parent"]
    conv2d = {"parent": discriminators.conv2d}
hp = load_config(os.path.join(root, "egs", "soak_r5", "vocoder.yaml"))
batch = cs.train_batch(hp, np.random.default_rng(0), dev)


def timed(task, state):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = task.train_step(state, batch)
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) * 1e3


out = {"highest": [], "default": {v: [] for v in variants}, "profile": {}}
task = VocoderTask(dict(hp, train_precision="highest"))
state = task.init_state(torch.Generator().manual_seed(1))
for i in range(3 + steps):
    state, ms = timed(task, state)
    if i >= 3:
        out["highest"].append(ms)
task = VocoderTask(dict(hp, train_precision="default"))
state = task.init_state(torch.Generator().manual_seed(1))
for v in variants:
    discriminators.conv2d = conv2d[v]
    for _ in range(2):
        state, _ = timed(task, state)
for r in range(steps):
    for v in variants[r % len(variants):] + variants[:r % len(variants)]:
        discriminators.conv2d = conv2d[v]
        state, ms = timed(task, state)
        out["default"][v].append(ms)
for v in variants:
    discriminators.conv2d = conv2d[v]
    launches = cs.denseconv.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        task.train_step(state, batch)
        torch.cuda.synchronize()
    evs = prof.key_averages()
    top = sorted((e for e in evs if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)[:12]
    out["profile"][v] = {
        "device_ms": sum(e.self_device_time_total for e in evs
                         if e.device_type == DeviceType.CUDA) / 1e3,
        "kernels": sum(e.count for e in evs if e.device_type == DeviceType.CUDA),
        "k3": cs.denseconv.launches - launches,
        "top_self_cpu": [[e.key, e.count, e.self_cpu_time_total / 1e3] for e in top]}
print(json.dumps(out))
"""


def host(parent: str) -> None:
    import subprocess

    default = collections.defaultdict(list)        # variant → every step's ms
    paired = collections.defaultdict(list)         # variant → ms minus "rounded" in its round
    for label in HOST_ORDER:
        root = os.path.abspath(parent) if label == "parent" else cs.ROOT
        res = subprocess.run([sys.executable, "-c", HOST_CODE, root, str(HOST_STEPS), label,
                              ",".join(HOST_VARIANTS)], capture_output=True, text=True,
                             check=True)
        r = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"host {label} highest: ms per step {[round(x, 3) for x in r['highest']]}, median "
              f"{np.median(r['highest']):.3f}", flush=True)
        for v, ms in r["default"].items():
            default[v] += ms
            if "rounded" in r["default"]:
                paired[v] += [a - b for a, b in zip(ms, r["default"]["rounded"])]
            p = r["profile"][v]
            print(f"host {label} default {v}: ms per step {[round(x, 3) for x in ms]}, median "
                  f"{np.median(ms):.3f}; profiled step device {p['device_ms']:.3f} ms, "
                  f"{p['kernels']} kernels, K3 forward launches {p['k3']}; most host time of "
                  f"their own: " + "; ".join(f"{k} x{n} {t:.2f} ms"
                                             for k, n, t in p["top_self_cpu"]), flush=True)
    for v, ms in default.items():
        q = np.percentile(ms, [25, 50, 75])
        print(f"host summary default {v}: {len(ms)} steps, median {q[1]:.3f} ms (quartiles "
              f"{q[0]:.3f}-{q[2]:.3f})" + (
                  f"; minus rounded in the same round: median {np.median(paired[v]):+.3f} ms "
                  f"(quartiles {np.percentile(paired[v], 25):+.3f} to "
                  f"{np.percentile(paired[v], 75):+.3f})" if v in paired else ""), flush=True)


# the step-0 geometries: Conan's k=31 and k=1 layers, the vocoder's 1024 ->
# 1024 k=5 and its 32 -> 32 k=11 resblock conv
PROFILE_GEOMETRIES = [(24, 1496, 256, 512, 31, 1, 1, 15, 15), (18, 125, 1024, 1024, 5, 1, 1, 2, 2),
                      (18, 8000, 32, 32, 11, 1, 5, 50, 0), (24, 1496, 256, 512, 1, 1, 1, 0, 0),
                      (24, 1496, 512, 256, 1, 1, 1, 0, 0)]
PROFILE_VARIANTS = ("full", "loads", "mma")


def probe_source(text: str, variant: str) -> str:
    """A K3 source as the probe ``variant`` builds it (profile's "loads":
    no wgmma statement; "mma": no TMA load, each barrier expecting no
    bytes)."""
    if variant == "loads":
        return re.sub(r"Wgmma<[^;]*;", ";", text, flags=re.S)
    if variant == "mma":
        text = re.sub(r"tma_load_[23]d\([^;]*;", ";", text, flags=re.S)
        return re.sub(r"mbar_expect_tx\(([^,;]+),[^;]*;", r"mbar_expect_tx(\1, 0);", text,
                      flags=re.S)
    return text


def build_variant(root: str, label: str, variant: str) -> str:
    """The port's kernel library of the tree at ``root``, its K3 sources
    patched by probe_source, built as ops/native.build does into
    build/denseconv_lab/<label>-<variant>/; returns the library's path."""
    out = os.path.join(OUT, f"{label}-{variant}")
    shutil.rmtree(out, ignore_errors=True)
    csrc = os.path.join(out, "csrc")
    shutil.copytree(os.path.join(root, "conan_tpu_torch", "csrc"), csrc)
    for name in ("denseconv.cu", "denseconv_bwd.cu"):
        path = os.path.join(csrc, name)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(probe_source(text, variant))
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
        elif "denseconv" in fn and ("Used" in line or "spill" in line) or "C75" in line:
            print(f"ptxas {label} {variant} {fn[:70]}:", line.strip()[:150], flush=True)
    return lib


# run in a child process whose first sys.path entry is the tree to time:
# argv[2] the library to load in place of the tree's own ("" for its own),
# argv[3] a JSON list of geometries, argv[4] "probe" where the checks only print
ROWS_CODE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from pathlib import Path
import torch
import chip_smoke as cs
from conan_tpu_torch.ops import denseconv as dc
from conan_tpu_torch.ops import native
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
if sys.argv[2]:
    native.LIB_PATH = Path(sys.argv[2])
native.load()
if sys.argv[4] == "probe":
    def fail(msg):
        print("probe, not checked:", msg[:120], file=sys.stderr)
    cs.fail = fail
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(0)
out = []
for g in json.loads(sys.argv[3]):
    row = cs.denseconv_row(tuple(g), {}, gen, dev)
    if "denseconv_wgrad_reduce_kernel" in open(
            Path(sys.argv[1]) / "conan_tpu_torch" / "csrc" / "denseconv_bwd.cu").read():
        B, T, Ci, Co, K, _s, d, pl, pr = g
        x = torch.randn(B, T, Ci, device=dev).to(torch.bfloat16)
        gy = torch.randn(B, T + pl + pr - d * (K - 1), Co, device=dev).to(torch.bfloat16)
        row["dw_reduce_device_ms"] = cs.kernel_device_ms(
            lambda: dc.denseconv.weight_grad(x, gy, (Co, Ci, K), dilation=d, padding=(pl, pr)),
            "denseconv_wgrad_reduce_kernel")
    out.append(row)
print(json.dumps(out))
"""


def tree_rows(root: str, geoms: list, lib: str = "", probe: bool = False) -> list[dict]:
    """chip_smoke.denseconv_row of the tree at ``root`` on ``geoms``, in a
    child process (``lib``: a library to load in place of the tree's)."""
    res = subprocess.run([sys.executable, "-c", ROWS_CODE, os.path.abspath(root), lib,
                          json.dumps(geoms), "probe" if probe else "check"],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"rows of {root} ({lib or 'its own library'}) failed:\n"
                         + res.stdout[-3000:] + res.stderr[-3000:])
    return json.loads(res.stdout.strip().splitlines()[-1])


def profile(roots: list[str], variants=PROFILE_VARIANTS, geoms=PROFILE_GEOMETRIES) -> None:
    geoms = [list(g) for g in geoms]
    libs = {(root, v): build_variant(root, f"tree{i}", v)
            for i, root in enumerate(roots) for v in variants}
    for root in roots:
        for v in variants:
            for g, r in zip(geoms, tree_rows(root, geoms, libs[root, v], probe=True)):
                B, T, Ci, Co, K, _s, d, pl, pr = g
                print(f"profile {root} {v}: B={B} T={T} {Ci}->{Co} k={K} d={d} pad=({pl},{pr}): "
                      + "; ".join(f"{k} bare {r[k + '_launch_ms']:.4f} ms device "
                                  f"{cs.ms_text(r[k + '_kernel_device_ms'])} (rel L2 from "
                                  f"float64 {r[k + '_rel_l2']:.3g})"
                                  for k in ("fwd", "dx", "dw"))
                      + (f"; dw's reduction device {cs.ms_text(r['dw_reduce_device_ms'])}"
                         if "dw_reduce_device_ms" in r else "")
                      + f"; bound {r['bound_ms']:.4g} ms by {r['bound_by']}", flush=True)


# the sweep's geometries: the forward's tile choice where the card holds
# few, many or very many tiles, the long k=31 conv, the k <= 2 convs whose
# fp32 output is most of their bytes, and dw's split and unsplit tiles
SWEEP_GEOMETRIES = [(24, 1496, 256, 512, 31, 1, 1, 15, 15), (24, 1496, 256, 512, 2, 1, 2, 2, 0),
                    (24, 1496, 512, 256, 1, 1, 1, 0, 0), (18, 32, 1024, 1024, 5, 1, 1, 2, 2),
                    (18, 125, 1024, 1024, 5, 1, 1, 2, 2), (18, 200, 256, 256, 7, 1, 1, 6, 0),
                    (24, 374, 80, 160, 5, 1, 1, 2, 2), (24, 2600, 8, 128, 2, 1, 40, 0, 0),
                    (18, 8000, 32, 32, 11, 1, 5, 50, 0), (18, 25, 512, 2048, 16, 1, 1, 15, 0)]


def sweep(dev: torch.device) -> None:
    """Bare launches of K3 (fwd, dx) at every tile of DENSE_TILES, each with
    4 or 8 weight stages and 2 to 4 windows in flight, and of K3 dw at
    every built (nb, tpw) and window share, unsplit and split as
    dense_wgrad_plan would; each result against the first's (DIFF where
    the forward's bits or dw's relative L2 past 1e-5 differ), the ms by
    CUDA events (4 * DENSE_ITERS after a warm call); the plans' choices
    starred."""
    from conan_tpu_torch.ops import denseconv as dc
    from conan_tpu_torch.ops.groupconv import sm_count

    import ctypes

    lib = native.load()
    sms = sm_count(dev.index or 0)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(0)
    for g in SWEEP_GEOMETRIES:
        B, T, Ci, Co, K, _s, d, pl, pr = g
        T_out = T + pl + pr - d * (K - 1)
        x = torch.randn(B, T, Ci, generator=gen).to(dev)
        w = ((torch.rand(Co, Ci, K, generator=gen) * 2 - 1) * (3 / (Ci * K)) ** 0.5).to(dev)
        gy = torch.randn(B, T_out, Co, generator=gen).to(dev)
        xb, gyb = dc._bf16_operand(x, "x"), dc._bf16_operand(gy, "gy")
        name = f"B={B} T={T} {Ci}->{Co} k={K} d={d}"
        for k, (src, N, C, T_in, T_o, pad, flip) in {
                "fwd": (xb, Co, Ci, T, T_out, pl, 0),
                "dx": (gyb, Ci, Co, T_out, T, d * (K - 1) - pl, 1)}.items():
            slots = B * -(-T_o // dc.SLOT)
            chosen = dc.dense_plan(C, N, K, d, slots, sms)
            tpr, rows = dc.dense_window(K, d)
            wq = torch.empty(N, K * dc._round_up(C, 64), dtype=torch.bfloat16, device=dev)
            if lib.denseconv_weights(w.data_ptr(), wq.data_ptr(), N, C, K, flip, stream):
                raise SystemExit("sweep: the weights' layout was refused")
            ref, out = None, []
            for bn, mi in dc.DENSE_TILES:
                if bn == 128 and dc._round_up(N, 128) > dc._round_up(N, 64):
                    continue
                for wst, xst in ((4, 2), (4, 3), (4, 4), (8, 2)):
                    if dc.dense_smem(bn, mi, rows, xst, wst) > dc.SMEM_LIMIT:
                        continue
                    maps = ctypes.create_string_buffer(256)
                    y = torch.empty(B, T_o, N, device=dev)
                    if lib.denseconv_describe(src.data_ptr(), wq.data_ptr(), B, T_in, C, N, K, bn,
                                              rows, ctypes.addressof(maps)):
                        raise SystemExit("sweep: the maps were refused")
                    args = (ctypes.addressof(maps), None, y.data_ptr(), B, T_o, C, N, K, d, pad,
                            bn, mi, tpr, rows, wst, xst, stream)
                    if lib.denseconv_run(*args):
                        raise SystemExit(f"sweep: {name} {k} ({bn}, {mi}, {wst}, {xst}) refused")
                    torch.cuda.synchronize()
                    ref = y.clone() if ref is None else ref
                    same = torch.equal(y, ref)
                    ms = cs.cuda_ms(lambda args=args: lib.denseconv_run(*args),
                                    iters=cs.DENSE_ITERS * 4, warmup=1)
                    mark = "*" if chosen.args == (bn, mi, tpr, rows, wst, xst) else ""
                    out.append(f"{mark}({bn},{mi},w{wst},x{xst}) {ms:.4f}{'' if same else ' DIFF'}")
            print(f"sweep {name} {k}: " + "; ".join(out), flush=True)
        plan = dc.dense_wgrad_plan(B, T_out, Ci, Co, K, d, sms)
        out, ref = [], None
        for nb, xboxes in ((128, 2), (128, 1), (64, 2), (64, 1)):
            for tpw in dc.WGRAD_TPW[nb]:
                taps = tpw * (3 - xboxes)
                win = dc._round_up(dc.WGRAD_ROWS + (taps - 1) * d, 8)
                stage = nb // 64 * dc.WGRAD_ROWS * 128 + xboxes * win * 128
                stages = min(dc.WGRAD_STAGES, (dc.SMEM_LIMIT - 1040) // (stage + 16))
                if taps > 2 * K or win > dc.MAX_WINDOW or stages < 2:
                    continue
                tiles = -(-Ci // (64 * xboxes)) * -(-Co // nb) * -(-K // taps)
                for splits in sorted({1, max(1, min(plan.n_chunks, sms // tiles))}):
                    ws = torch.empty(max(1, tiles * splits * tpw * nb // 2 * 256), device=dev)
                    cnt = torch.zeros(2 * tiles, dtype=torch.int32, device=dev)
                    dw = torch.empty(Co, Ci, K, device=dev)
                    args = (xb.data_ptr(), gyb.data_ptr(), ws.data_ptr(), cnt.data_ptr(),
                            dw.data_ptr(), B, T, Ci, T_out, Co, K, d, pl, nb, tpw, xboxes,
                            stages, win, splits, stream)
                    if lib.denseconv_weight_grad(*args):
                        continue
                    torch.cuda.synchronize()
                    ref = dw.clone() if ref is None else ref
                    close = cs.rel_l2(dw.double(), ref.double()) < 1e-5
                    ms = cs.cuda_ms(lambda args=args: lib.denseconv_weight_grad(*args),
                                    iters=cs.DENSE_ITERS * 4, warmup=1)
                    mark = "*" if (plan.tiles.nb, plan.tiles.tpw, plan.tiles.xboxes,
                                   plan.splits) == (nb, tpw, xboxes, splits) else ""
                    out.append(f"{mark}({nb},t{tpw},x{xboxes},s{splits}) {ms:.4f}"
                               + ("" if close else " DIFF"))
        print(f"sweep {name} dw: " + "; ".join(out), flush=True)


COMPARE_ORDER = ("parent", "change", "change", "parent")


def compare(parent: str) -> None:
    with open(os.path.join(cs.ROOT, "tools", "denseconv_geometries.json")) as f:
        recorded = json.load(f)
    geoms = [g for g, _ in recorded]
    runs = collections.defaultdict(list)
    for label in COMPARE_ORDER:
        t0 = time.perf_counter()
        runs[label].append(tree_rows(parent if label == "parent" else cs.ROOT, geoms))
        print(f"compare: {label} rows in {time.perf_counter() - t0:.1f} s", flush=True)
    keys = [f"{k}_{m}" for k in ("fwd", "dx", "dw") for m in ("launch_ms", "kernel_device_ms")]

    def mean(label, i, key):
        vals = [rows[i][key] for rows in runs[label]]
        return None if None in vals else sum(vals) / len(vals)

    sums = collections.defaultdict(float)     # (task, side, key) → ms a step
    for i, (g, calls) in enumerate(recorded):
        side = {lab: {k: mean(lab, i, k) for k in keys} for lab in ("parent", "change")}
        bound = runs["change"][0][i]["bound_ms"]
        print(f"compare B={g[0]} T={g[1]} {g[2]}->{g[3]} k={g[4]} d={g[6]} pad=({g[7]},{g[8]}) "
              f"calls {calls}: " + "; ".join(
                  f"{k} bare {side['parent'][k + '_launch_ms']:.4f} -> "
                  f"{side['change'][k + '_launch_ms']:.4f} ms "
                  f"({side['change'][k + '_launch_ms'] / side['parent'][k + '_launch_ms']:.2f}x)"
                  f", device {cs.ms_text(side['parent'][k + '_kernel_device_ms'])} -> "
                  f"{cs.ms_text(side['change'][k + '_kernel_device_ms'])}"
                  for k in ("fwd", "dx", "dw")) + f"; bound {bound:.4g} ms", flush=True)
        for task, n in calls.items():
            sums[task, "bound", ""] += n * bound
            for lab in ("parent", "change"):
                for k in keys:
                    v = side[lab][k] if side[lab][k] is not None else side[lab][
                        k.replace("kernel_device_ms", "launch_ms")]
                    sums[task, lab, k] += n * v
    for task in sorted({t for _, c in recorded for t in c}):
        print(f"compare sums, {task}, weighted by the calls a step (ms a step): "
              + "; ".join(f"{k} bare {sums[task, 'parent', k + '_launch_ms']:.4f} -> "
                          f"{sums[task, 'change', k + '_launch_ms']:.4f}, device "
                          f"{sums[task, 'parent', k + '_kernel_device_ms']:.4f} -> "
                          f"{sums[task, 'change', k + '_kernel_device_ms']:.4f}"
                          for k in ("fwd", "dx", "dw"))
              + f"; bound {sums[task, 'bound', '']:.4f} a kernel", flush=True)


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] not in ("step0", "leaf", "k3", "route", "host",
                                                "profile", "compare", "sweep"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("torch_denseconv_lab: needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip(), flush=True)
    if sys.argv[1] == "k3":
        k3(dev, "--watchdog" in sys.argv)
        return
    if sys.argv[1] == "sweep":
        native.build()
        sweep(dev)
        return
    if sys.argv[1] == "route":
        route(sys.argv[2])
        return
    if sys.argv[1] == "host":
        host(sys.argv[2])
        return
    if sys.argv[1] == "profile":
        args = sys.argv[2:]
        kw = {}
        if "--variants" in args:
            i = args.index("--variants")
            kw["variants"] = tuple(args[i + 1].split(","))
            args = args[:i] + args[i + 2:]
        if "--watchdog" in args:     # a pipeline that deadlocks traps instead of hanging
            native.COMPILE_FLAGS.append("-DK2BF16_WATCHDOG")
            args.remove("--watchdog")
        if "--k3" in args:           # K3_GEOMETRIES in place of the step-0 profile's
            kw["geoms"] = K3_GEOMETRIES
            args.remove("--k3")
        profile(args, **kw)
        return
    if sys.argv[1] == "compare":
        compare(sys.argv[2])
        return
    native.build()
    if sys.argv[1] == "step0":
        tasks = ["conan", "vocoder", "postnet"]
        if "--tasks" in sys.argv:
            tasks = sys.argv[sys.argv.index("--tasks") + 1].split(",")
        step0(dev, tasks)
    else:
        leaf(dev, int(sys.argv[2]) if len(sys.argv) > 2 else 0)


if __name__ == "__main__":
    main()
