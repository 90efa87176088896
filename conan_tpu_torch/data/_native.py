"""The native record reader (``conan_tpu/data/_native.py``): ctypes bindings
of ``native/record_reader.cc``, built by ``g++`` at first use into
``build/conan_tpu_torch/librecordreader.so`` under the checkout root (under
the build lock of ``ops/native.py``, so concurrent ranks or test workers
build it once). A failed build raises with g++'s output; nothing falls back
to the Python reader quietly (``RecordReader(use_native=False)`` reads with
Python). Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import pickle
import subprocess
from pathlib import Path

import numpy as np

from conan_tpu_torch.ops.native import BUILD_DIR, build_locked

SOURCE = Path(__file__).resolve().parent / "native" / "record_reader.cc"
LIB_PATH = BUILD_DIR / "librecordreader.so"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def build(force: bool = False) -> str:
    """Compile the reader if it is missing or older than its source; g++'s
    output, "" when it was up to date."""
    def compile_fn(lib_tmp: Path) -> str:
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(lib_tmp)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the native record reader cannot be built "
                               "(RecordReader(use_native=False) reads with Python)") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}")
        return proc.stdout

    return build_locked(LIB_PATH, [SOURCE], compile_fn, force)


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its functions."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    P64 = ctypes.POINTER(ctypes.c_int64)
    lib.rs_open.restype = P
    lib.rs_open.argtypes = [ctypes.c_char_p, P64, I64]
    lib.rs_len.restype = I64
    lib.rs_len.argtypes = [P]
    lib.rs_item.restype = ctypes.c_int
    lib.rs_item.argtypes = [P, I64, ctypes.POINTER(P), P64]
    lib.rs_gather.restype = I64
    lib.rs_gather.argtypes = [P, P64, I64, ctypes.c_char_p, I64, P64, ctypes.c_int]
    lib.rs_prefault.restype = None
    lib.rs_prefault.argtypes = [P, P64, I64, ctypes.c_int]
    lib.rs_close.restype = None
    lib.rs_close.argtypes = [P]
    return lib


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativeReader:
    """mmap zero-copy reader over a ``<path>.data`` / ``<path>.idx`` store."""

    def __init__(self, path: str, n_threads: int = 4):
        self._lib = load()
        idx = np.load(f"{path}.idx", allow_pickle=True).item()
        self.offsets = np.ascontiguousarray(np.asarray(idx["offsets"], np.int64))
        self._h = self._lib.rs_open(f"{path}.data".encode(), _p64(self.offsets),
                                    len(self.offsets))
        if not self._h:
            raise OSError(f"rs_open failed for {path}.data")
        self.n_threads = n_threads

    def __len__(self) -> int:
        return int(self._lib.rs_len(self._h))

    def _indices(self, indices) -> np.ndarray:
        idxs = np.ascontiguousarray(np.asarray(indices, np.int64).reshape(-1))
        bad = idxs[(idxs < 0) | (idxs >= len(self))]
        if len(bad):
            raise IndexError(f"record index {int(bad[0])} out of range [0, {len(self)})")
        return idxs

    def read_raw(self, i: int) -> memoryview:
        """Item ``i``'s bytes, a view into the mapped file (valid until
        ``close``)."""
        ptr, ln = ctypes.c_void_p(), ctypes.c_int64()
        rc = self._lib.rs_item(self._h, int(i), ctypes.byref(ptr), ctypes.byref(ln))
        if rc != 0:
            raise IndexError(f"record index {i} out of range [0, {len(self)})" if rc == -1
                             else f"record {i}'s offsets lie outside the data file")
        if ln.value == 0:
            return memoryview(b"")
        return memoryview((ctypes.c_char * ln.value).from_address(ptr.value)).cast("B")

    def __getitem__(self, i: int):
        return pickle.loads(self.read_raw(i))

    def gather(self, indices) -> list[bytes]:
        """The items' bytes, copied on ``n_threads`` threads in one call."""
        idxs = self._indices(indices)
        lens = np.zeros(len(idxs), np.int64)
        cap = int((self.offsets[idxs + 1] - self.offsets[idxs]).sum())
        buf = ctypes.create_string_buffer(max(cap, 1))
        total = self._lib.rs_gather(self._h, _p64(idxs), len(idxs), buf, cap, _p64(lens),
                                    self.n_threads)
        if total < 0:
            raise RuntimeError(f"rs_gather failed ({total})")
        raw = buf.raw
        ends = np.cumsum(lens)
        return [raw[e - n:e] for n, e in zip(lens.tolist(), ends.tolist())]

    def prefault(self, indices) -> None:
        """Touch the items' pages on ``n_threads`` threads."""
        idxs = self._indices(indices)
        self._lib.rs_prefault(self._h, _p64(idxs), len(idxs), self.n_threads)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.rs_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
