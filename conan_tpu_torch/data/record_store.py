"""The binary record store (``conan_tpu/data/record_store.py``), in the
format of the reference's IndexedDataset: ``<path>.data`` is the pickled
items one after another and ``<path>.idx`` an np-saved dict whose
``offsets`` array holds each item's byte offset (and the end). The JAX
package's stores and this one's read each other. Reading is pure Python
(``os.pread`` and an LRU cache of items); the JAX package's native reader is
not ported.
"""

from __future__ import annotations

import os
import pickle
from collections import OrderedDict

import numpy as np


class RecordReader:
    NUM_CACHE = 16      # items kept, least recently read dropped first

    def __init__(self, path: str):
        self.path = path
        idx = np.load(f"{path}.idx", allow_pickle=True).item()
        self.offsets = np.asarray(idx["offsets"], np.int64)
        self._fd = os.open(f"{path}.data", os.O_RDONLY)
        self._cache: OrderedDict[int, object] = OrderedDict()

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def read_raw(self, i: int) -> bytes:
        n = int(self.offsets[i + 1] - self.offsets[i])
        return os.pread(self._fd, n, int(self.offsets[i]))

    def __getitem__(self, i: int):
        if i < 0 or i >= len(self):
            raise IndexError(i)
        if i in self._cache:
            self._cache.move_to_end(i)
            return self._cache[i]
        item = pickle.loads(self.read_raw(i))
        self._cache[i] = item
        if len(self._cache) > self.NUM_CACHE:
            self._cache.popitem(last=False)
        return item

    def close(self) -> None:
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
