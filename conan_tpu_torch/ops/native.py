"""Build and load the port's hand-written CUDA kernel library.

The sources in ``csrc/`` (``logmel.cu``: K1, ``groupconv.cu``: K2, and the
header ``common.cuh`` they share) are compiled by one ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface,
``build/conan_tpu_torch/libconan_kernels.so`` under the checkout root, which
``ctypes`` loads. The build runs at first use, and again whenever
a source is newer than the library. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
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
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "/usr/local/cuda") + "/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(force: bool = False) -> str:
    """Compile the library if it is missing or older than a source. Returns
    nvcc's diagnostics (ptxas register and shared-memory report per kernel);
    empty when the library was already up to date."""
    if (not force and LIB_PATH.exists()
            and LIB_PATH.stat().st_mtime >= max(f.stat().st_mtime for f in SOURCES + HEADERS)):
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib_tmp = Path(tmp) / LIB_PATH.name
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *map(str, SOURCES), "-o", str(lib_tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {[src.name for src in SOURCES]}:\n{proc.stdout}")
        os.replace(lib_tmp, LIB_PATH)
    return proc.stdout


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
    return lib
