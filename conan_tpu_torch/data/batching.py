"""Batching (``conan_tpu/data/batching.py``): token-budget packing and the
bucket ladder.

``batch_by_size`` packs length-sorted, shuffled indices under ``max_tokens``
× ``max_sentences`` as the reference does (dataset_utils.py:94-148). The
``BucketLadder`` rounds a batch's longest item up to one of a few lengths:
the collated batch is padded to that length, which is what the losses'
padding masks and the mel discriminator's crops read, so the port keeps it.
"""

from __future__ import annotations

import sys

import numpy as np


def batch_by_size(indices, num_tokens_fn, max_tokens=None, max_sentences=None,
                  required_batch_size_multiple: int = 1) -> list[list[int]]:
    max_tokens = max_tokens if max_tokens is not None else sys.maxsize
    max_sentences = max_sentences if max_sentences is not None else sys.maxsize
    bsz_mult = required_batch_size_multiple
    sample_len = 0
    sample_lens: list[int] = []
    batch: list[int] = []
    batches: list[list[int]] = []
    for idx in indices:
        idx = int(idx)
        n = num_tokens_fn(idx)
        sample_lens.append(n)
        sample_len = max(sample_len, n)
        if sample_len > max_tokens:
            raise ValueError(f"item {idx} has {sample_len} tokens, over max_tokens {max_tokens}")
        num_tokens = (len(batch) + 1) * sample_len
        if len(batch) > 0 and (num_tokens > max_tokens or len(batch) == max_sentences):
            mod_len = max(bsz_mult * (len(batch) // bsz_mult), len(batch) % bsz_mult)
            batches.append(batch[:mod_len])
            batch = batch[mod_len:]
            sample_lens = sample_lens[mod_len:]
            sample_len = max(sample_lens) if sample_lens else 0
        batch.append(idx)
    if batch:
        batches.append(batch)
    return batches


def size_shuffled_indices(sizes, rng: np.random.Generator, sort_by_len: bool = True):
    """A permutation, then a stable sort by size (the reference's
    ordered_indices)."""
    idx = rng.permutation(len(sizes))
    if sort_by_len:
        idx = idx[np.argsort(np.asarray(sizes)[idx], kind="mergesort")]
    return idx


class BucketLadder:
    """Lengths from ``min_len`` growing by ``growth``, each rounded up to a
    ``multiple``, up to ``max_len``; ``fit`` gives the first that holds a
    length (the last one for anything longer)."""

    def __init__(self, min_len: int = 128, max_len: int = 3000, growth: float = 1.3,
                 multiple: int = 8):
        lens = []
        length = float(min_len)
        while length < max_len:
            lens.append(int(-(-length // multiple) * multiple))
            length *= growth
        lens.append(int(-(-max_len // multiple) * multiple))
        self.lengths = sorted(set(lens))

    def fit(self, length: int) -> int:
        for rung in self.lengths:
            if length <= rung:
                return rung
        return self.lengths[-1]


def collate_1d(arrs: list[np.ndarray], pad_value=0, target_len: int | None = None) -> np.ndarray:
    T = target_len or max(len(a) for a in arrs)
    out = np.full((len(arrs), T), pad_value, dtype=arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, :len(a)] = a[:T]
    return out


def collate_2d(arrs: list[np.ndarray], pad_value=0.0,
               target_len: int | None = None) -> np.ndarray:
    T = target_len or max(a.shape[0] for a in arrs)
    out = np.full((len(arrs), T, arrs[0].shape[1]), pad_value, dtype=arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, :a.shape[0]] = a[:T]
    return out


def shard_for_replicas(batches: list[list[int]], num_replicas: int,
                       rank: int | None = None) -> list[list[int]]:
    """The rank's share of a list of batches, padded to a multiple of
    ``num_replicas`` by repeating its first batches (the reference's
    dataset_utils.py:317-329): every ``num_replicas``-th batch from
    ``rank``, or with ``rank`` None the padded list. The loader does not
    call it, as the JAX package's does not: under data parallelism each rank
    takes its contiguous block of every global batch
    (``loader.BatchIterator``)."""
    if num_replicas <= 1:
        return batches
    if len(batches) % num_replicas != 0:
        batches = batches + batches[: num_replicas - len(batches) % num_replicas]
    if rank is None:
        return batches
    return batches[rank::num_replicas]
