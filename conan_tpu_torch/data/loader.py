"""The input pipeline (``conan_tpu/data/loader.py``): collated numpy batches
built on a background thread and handed over through a bounded queue.

Each epoch shuffles the items (``size_shuffled_indices``), packs them by
``batch_by_size`` and shuffles the batches; with a ``BucketLadder`` each
batch is padded to its rung. An error in the producer thread is raised in
the consumer, so a data fault ends training with that error rather than
looking like the end of the data.

With a ``world`` (``parallel/dist.py``) every rank makes the same global
batches and yields its block of each: it plans every item of the global
batch (``dataset.plan``: the item's random choices, so the generator
advances as on one rank, and its lengths), pads the plans to a multiple of
the world's size by repeating leading rows (``pad_batch_to_multiple``),
loads only its own rows and collates them at the global batch's rung (the
longest item's, and for Conan the longest reference's), so that every rank's
shapes agree. Without a ladder the collate must give the same shapes on
every rank by itself (the vocoder's fixed crops).
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
                 max_sentences: int | None, bucket: BucketLadder | None = None,
                 world=None):
        self.world = world
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
        if self.world is not None:
            return self._make_local_batch(index_list)
        samples = [self.ds[i] for i in index_list]
        if self.bucket is not None:
            max_len = max(s["mel"].shape[0] if "mel" in s else len(s["content"])
                          for s in samples)
            return self.collate(samples, target_len=self.bucket.fit(max_len))
        return self.collate(samples)

    def _make_local_batch(self, index_list: list[int]) -> dict:
        """This rank's rows of the padded global batch of ``index_list``."""
        plans = [self.ds.plan(i) for i in index_list]
        n = self.world.size
        plans = [plans[j % len(plans)] for j in range(len(plans) + (-len(plans)) % n)]
        samples = [self.ds.load(p) for p in plans[self.world.block(len(plans) // n)]]
        if self.bucket is None:
            return self.collate(samples)
        lengths = {"target_len": self.bucket.fit(max(p["frames"] for p in plans))}
        if "ref_frames" in plans[0]:
            lengths["ref_target_len"] = self.bucket.fit(max(p["ref_frames"] for p in plans))
        return self.collate(samples, **lengths)

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
