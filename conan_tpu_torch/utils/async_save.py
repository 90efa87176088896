"""A thread pool for saving outputs while the card works on the next item
(``conan_tpu/utils/async_save.py``). Threads suffice: saving is file I/O and
C code that releases the interpreter lock."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor


class AsyncSaver:
    def __init__(self, workers: int = 4):
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._futures = []

    def submit(self, fn, *args, **kwargs) -> None:
        self._futures.append(self._pool.submit(fn, *args, **kwargs))

    def join(self) -> list:
        """Wait for every submitted call; re-raises the first one's error."""
        out = [f.result() for f in self._futures]
        self._futures.clear()
        return out

    def close(self) -> None:
        try:
            self.join()
        finally:
            self._pool.shutdown()
