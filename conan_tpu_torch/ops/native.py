"""Build and load the port's hand-written CUDA kernel library.

The sources in ``csrc/`` (``logmel.cu``: K1, ``groupconv.cu``: K2, and the
header ``common.cuh`` they share) are compiled by one ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface,
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
SOURCES = tuple(CSRC / name for name in ("logmel.cu", "groupconv.cu"))
HEADERS = (CSRC / "common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "conan_tpu_torch"
LIB_PATH = BUILD_DIR / "libconan_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas=-v", "-ldl"]


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
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *map(str, SOURCES), "-o", str(lib_tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {[src.name for src in SOURCES]}:\n{proc.stdout}")
        return proc.stdout

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
    for fn in (lib.groupconv_forward_bf16, lib.groupconv_bf16_weights,
               lib.groupconv_bf16_describe, lib.groupconv_bf16_conv):
        fn.restype = ctypes.c_int
    return lib
