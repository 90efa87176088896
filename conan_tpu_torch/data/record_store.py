"""The binary record store (``conan_tpu/data/record_store.py``), in the
format of the reference's IndexedDataset: ``<path>.data`` is the pickled
items one after another and ``<path>.idx`` an np-saved dict whose
``offsets`` array holds each item's byte offset (and the end). The JAX
package's stores and this one's read each other. ``RecordReader`` reads
through the native reader (``data/_native.py``: the mmap'd file, C++, built
by g++ at first use) by default, as the JAX package's does, and with
``use_native=False`` with Python (``os.pread``); both keep an LRU cache of
items. A reader that cannot be built raises: nothing falls back quietly.
"""

from __future__ import annotations

import os
import pickle
from collections import OrderedDict

import numpy as np


class RecordReader:
    NUM_CACHE = 16      # items kept, least recently read dropped first

    def __init__(self, path: str, use_native: bool = True):
        self.path = path
        idx = np.load(f"{path}.idx", allow_pickle=True).item()
        self.offsets = np.asarray(idx["offsets"], np.int64)
        self._native = None
        self._fd = None
        if use_native:
            from conan_tpu_torch.data._native import NativeReader

            self._native = NativeReader(path)
        else:
            self._fd = os.open(f"{path}.data", os.O_RDONLY)
        self._cache: OrderedDict[int, object] = OrderedDict()

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def _check(self, i: int) -> None:
        if i < 0 or i >= len(self):
            raise IndexError(f"record index {i} out of range [0, {len(self)})")

    def read_raw(self, i: int) -> bytes:
        self._check(i)
        if self._native is not None:
            return bytes(self._native.read_raw(i))
        n = int(self.offsets[i + 1] - self.offsets[i])
        return os.pread(self._fd, n, int(self.offsets[i]))

    def gather(self, indices) -> list[bytes]:
        """The bytes of several items in one call (the native reader's
        threaded copy; one ``read_raw`` each in Python)."""
        if self._native is not None:
            return self._native.gather(indices)
        return [self.read_raw(int(i)) for i in indices]

    def prefault(self, indices) -> None:
        """Page the items in ahead of their reads (native only; Python
        reads need no warm-up)."""
        if self._native is not None:
            self._native.prefault(indices)
        else:
            for i in indices:
                self._check(int(i))

    def __getitem__(self, i: int):
        self._check(i)
        if i in self._cache:
            self._cache.move_to_end(i)
            return self._cache[i]
        item = pickle.loads(self._native.read_raw(i) if self._native is not None
                            else self.read_raw(i))
        self._cache[i] = item
        if len(self._cache) > self.NUM_CACHE:
            self._cache.popitem(last=False)
        return item

    def close(self) -> None:
        if getattr(self, "_native", None) is not None:
            self._native.close()
            self._native = None
        if getattr(self, "_fd", None) is not None:
            os.close(self._fd)
            self._fd = None

    def __del__(self):
        self.close()


class RecordWriter:
    """Appends pickled items; ``finalize`` closes the data file and writes
    the index."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(f"{path}.data", "wb")
        self.offsets = [0]

    def add_item(self, item) -> None:
        n = self._f.write(pickle.dumps(item))
        self.offsets.append(self.offsets[-1] + n)

    def finalize(self) -> None:
        self._f.close()
        with open(f"{self.path}.idx", "wb") as f:
            np.save(f, {"offsets": self.offsets})
