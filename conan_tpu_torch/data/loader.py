"""The input pipeline (``conan_tpu/data/loader.py``): collated numpy batches
built on a background thread and handed over through a bounded queue.

Each epoch shuffles the items (``size_shuffled_indices``), packs them by
``batch_by_size`` and shuffles the batches; with a ``BucketLadder`` each
batch is padded to its rung. An error in the producer thread is raised in
the consumer, so a data fault ends training with that error rather than
looking like the end of the data.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np

from conan_tpu_torch.data.batching import BucketLadder, batch_by_size, size_shuffled_indices


class BatchIterator:
    """Endless iterator of collated batches, epoch after epoch, with up to
    PREFETCH batches made ahead. Its random order comes from a numpy
    generator seeded as the JAX package's."""

    SEED, PREFETCH = 1234, 4

    def __init__(self, dataset, collate_fn: Callable, *, max_tokens: int | None,
                 max_sentences: int | None, bucket: BucketLadder | None = None):
        self.ds = dataset
        self.collate = collate_fn
        self.max_tokens = max_tokens
        self.max_sentences = max_sentences
        self.rng = np.random.default_rng(self.SEED)
        self.bucket = bucket

    def _epoch_batches(self) -> list[list[int]]:
        sizes = np.asarray(self.ds.sizes)
        batches = batch_by_size(size_shuffled_indices(sizes, self.rng),
                                lambda i: int(sizes[i]), max_tokens=self.max_tokens,
                                max_sentences=self.max_sentences)
        self.rng.shuffle(batches)
        return batches

    def _make_batch(self, index_list: list[int]) -> dict:
        samples = [self.ds[i] for i in index_list]
        if self.bucket is not None:
            max_len = max(s["mel"].shape[0] if "mel" in s else len(s["content"])
                          for s in samples)
            return self.collate(samples, target_len=self.bucket.fit(max_len))
        return self.collate(samples)

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()
        err: list[BaseException] = []

        def put(item) -> bool:
            """Blocks until there is room or the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                while not stop.is_set():
                    for bl in self._epoch_batches():
                        batch = self._make_batch(bl)
                        if batch and not put(batch):
                            return
            except BaseException as e:   # raised again in the consumer
                err.append(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is None:
                    if err:
                        raise RuntimeError("data pipeline producer failed") from err[0]
                    return
                yield b
        finally:
            stop.set()
            t.join()
