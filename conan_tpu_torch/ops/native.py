"""Build and load the port's hand-written CUDA kernel library.

The sources in ``csrc/`` (``logmel.cu``: K1, ``groupconv.cu``: K2, K2-bf16
and its input gradient, ``groupconv_bwd.cu``: K2-bf16's weight gradient,
``denseconv.cu``: K3 and its input gradient, ``denseconv_bwd.cu``: K3's
weight gradient, and the headers ``common.cuh`` and ``k2bf16.cuh`` they
share) are compiled for
``sm_90a``, one ``nvcc`` a source, all started together, then linked into a
shared library with a plain C interface,
``build/conan_tpu_torch/libconan_kernels.so`` under the checkout root, which
``ctypes`` loads. The build runs at first use, and again whenever
a source is newer than the library. Nothing here runs at import.

Every build into ``build/conan_tpu_torch/`` (this library and the record
reader's, ``data/_native.py``) goes through ``build_locked``: the check and
the build run under an exclusive ``fcntl`` lock on the target's directory,
so N ranks or N test workers that start at once build it once and the
others load what it built.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = tuple(CSRC / name for name in ("logmel.cu", "groupconv.cu", "groupconv_bwd.cu",
                                         "denseconv.cu", "denseconv_bwd.cu"))
HEADERS = (CSRC / "common.cuh", CSRC / "k2bf16.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "conan_tpu_torch"
LIB_PATH = BUILD_DIR / "libconan_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas=-v", "-ldl"]
# NVCC_FLAGS as one source's compile to an object
COMPILE_FLAGS = [f for f in NVCC_FLAGS if f not in ("-shared", "-ldl")] + ["-c"]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "/usr/local/cuda") + "/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


@contextlib.contextmanager
def _locked(directory: Path):
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / ".build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_locked(target: Path, sources, compile_fn, force: bool = False) -> str:
    """Build ``target`` unless it is newer than every one of ``sources``
    (or ``force``), holding the directory's build lock from the check to the
    rename: ``compile_fn(path)`` writes the library to ``path`` in a
    temporary directory beside the target (raising on failure) and returns
    the compiler's output, which this returns; "" when up to date."""
    with _locked(target.parent):
        if (not force and target.exists()
                and target.stat().st_mtime >= max(Path(f).stat().st_mtime for f in sources)):
            return ""
        with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
            out = compile_fn(Path(tmp) / target.name)
            os.replace(Path(tmp) / target.name, target)
        return out


def build(force: bool = False) -> str:
    """Compile the library if it is missing or older than a source. Returns
    nvcc's diagnostics (ptxas register and shared-memory report per kernel);
    empty when the library was already up to date."""
    def compile_fn(lib_tmp: Path) -> str:
        nvcc = _nvcc()
        objs = [lib_tmp.parent / (src.stem + ".o") for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [src.name for src, proc in zip(SOURCES, procs) if proc.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, *NVCC_FLAGS, *map(str, objs), "-o", str(lib_tmp)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
            failed = ["the link"] if link.returncode != 0 else []
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(logs))
        return "".join(logs)

    return build_locked(LIB_PATH, SOURCES + HEADERS, compile_fn, force)


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its launchers, each
    of which returns cudaGetLastError() after its launch."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # wav, window, twiddles, band first, band count, band offset, band
    # weights, out, B, T, n_frames, n_fft, hop, pad, n_mels, eps_under_sqrt,
    # clip, out_scale, stream
    lib.logmel_forward.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, F, F, P]
    lib.logmel_forward.restype = ctypes.c_int
    # x, w_hi, w_lo, y, B, T, Ci, T_out, Co, groups, K, stride, pad_l, stream
    lib.groupconv_forward.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, I, P]
    lib.groupconv_forward.restype = ctypes.c_int
    # K2-bf16: geometry B, T, Ci, T_out, Co, groups, K, stride, pad_l and the
    # plan's (bn, mi, nwg, kc, stages, win_rows, win_u)
    geometry_plan = [I] * 16
    # x, w, wq (the weights' layout, written), y, geometry and plan, stream
    lib.groupconv_forward_bf16.argtypes = [P, P, P, P, *geometry_plan, P]
    # w, wq, Co, cig, K, stream
    lib.groupconv_bf16_weights.argtypes = [P, P, I, I, I, P]
    # x, wq, B, T, Ci, Co, groups, K, bn, maps (256 bytes, written)
    lib.groupconv_bf16_describe.argtypes = [P, P, I, I, I, I, I, I, I, P]
    # maps, y, geometry and plan, stream
    lib.groupconv_bf16_conv.argtypes = [P, P, *geometry_plan, P]
    # K2-bf16 dx: gy, w, wq (written), dx, the forward's geometry and the
    # phases' plan, stream
    lib.groupconv_input_grad_bf16.argtypes = [P, P, P, P, *geometry_plan, P]
    # w, wq, Ci, Co, groups, K, stride, stream
    lib.groupconv_bf16_dx_weights.argtypes = [P, P, I, I, I, I, I, P]
    # maps, dx, geometry and plan, stream
    lib.groupconv_bf16_dx_conv.argtypes = [P, P, *geometry_plan, P]
    # K2-bf16 dw: x, gy, ws and counters (or None: an unsplit plan), dw,
    # geometry B, T, Ci, T_out, Co, groups, K, stride, pad_l and the plan's
    # (nwg, tpw, splits, stages, stg_rows), stream
    lib.groupconv_weight_grad_bf16.argtypes = [P, P, P, P, P, *[I] * 14, P]
    # K3: x, w, wq (the weights' layout, written), bias or None, y, B, T, C,
    # T_out, N, K, dilation, pad_l, flip, and the plan's (bn, mi, tpr,
    # win_rows, wstages, xstages), stream
    lib.denseconv_forward.argtypes = [P, P, P, P, P, *[I] * 15, P]
    # w, wq, N, C, K, flip, stream
    lib.denseconv_weights.argtypes = [P, P, I, I, I, I, P]
    # x, wq, B, T, C, N, K, bn, win_rows, maps (256 bytes, written)
    lib.denseconv_describe.argtypes = [P, P, I, I, I, I, I, I, I, P]
    # maps, bias or None, y, B, T_out, C, N, K, dilation, pad_l, and the
    # plan's (bn, mi, tpr, win_rows, wstages, xstages), stream
    lib.denseconv_run.argtypes = [P, P, P, *[I] * 13, P]
    # K3 dw: x, gy, ws or None, counters or None, dw, B, T, C, T_out, N, K,
    # dilation, pad_l and the plan's (nb, tpw, xboxes, stages, win_rows,
    # splits), stream
    lib.denseconv_weight_grad.argtypes = [P, P, P, P, P, *[I] * 14, P]
    for fn in (lib.groupconv_forward_bf16, lib.groupconv_bf16_weights,
               lib.groupconv_bf16_describe, lib.groupconv_bf16_conv,
               lib.groupconv_input_grad_bf16, lib.groupconv_bf16_dx_weights,
               lib.groupconv_bf16_dx_conv, lib.groupconv_weight_grad_bf16,
               lib.denseconv_forward, lib.denseconv_weights, lib.denseconv_describe,
               lib.denseconv_run, lib.denseconv_weight_grad):
        fn.restype = ctypes.c_int
    return lib
