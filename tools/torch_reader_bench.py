#!/usr/bin/env python3
"""The port's record reader on the host: the native reader (mmap, C++,
``data/_native.py``) against the Python one (``os.pread``), on a store of
synthesized Conan items, the same both ways.

    python3 tools/torch_reader_bench.py [--items 256] [--batches 40] [--out build/reader_bench]

The store holds ``--items`` items of 1400-1500 frames (chip_smoke.py's
conan_train corpus lengths): an 80-bin fp32 mel, content codes, F0 and a
speaker id of 4, with ``train_lengths.npy`` and ``train_spk_ids.npy``, in
``--out`` (the page cache warm: the store was just written). Then, for each
reader, in the order native, Python, native, Python:

  item    ``RecordReader`` opened anew, every item read once in a shuffled
          order through ``__getitem__`` (no cache hit): ms per item
  loader  ``train.run.build_train_iter(hp, "conan")`` on
          egs/soak_r5/conan.yaml with the reader swapped in: wall ms to the
          first ``--batches`` batches, and ms per batch over the ones after
          the first (the producer thread keeps 4 batches ahead)

and prints one JSON line. Host only: no device is used.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from conan_tpu_torch.config import load_config  # noqa: E402
from conan_tpu_torch.data import datasets  # noqa: E402
from conan_tpu_torch.data.record_store import RecordReader, RecordWriter  # noqa: E402
from conan_tpu_torch.train.run import build_train_iter  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def write_store(out: str, n: int, seed: int = 0) -> int:
    rng = np.random.default_rng(seed)
    os.makedirs(out, exist_ok=True)
    w = RecordWriter(os.path.join(out, "train"))
    lengths, spk = [], []
    for i in range(n):
        T = int(rng.integers(1400, 1501))
        w.add_item({"item_name": f"utt{i:05d}", "spk_id": i % 4,
                    "mel": rng.standard_normal((T, 80)).astype(np.float32),
                    "hubert": rng.integers(0, 100, T).astype(np.int64),
                    "f0": (rng.random(T) * 200 + 100).astype(np.float32)})
        lengths.append(T)
        spk.append(i % 4)
    w.finalize()
    np.save(os.path.join(out, "train_lengths.npy"), np.asarray(lengths))
    np.save(os.path.join(out, "train_spk_ids.npy"), np.asarray(spk))
    return os.path.getsize(os.path.join(out, "train.data"))


def time_items(out: str, native: bool) -> float:
    r = RecordReader(os.path.join(out, "train"), use_native=native)
    order = np.random.default_rng(1).permutation(len(r))
    t0 = time.perf_counter()
    for i in order:
        r[int(i)]
    ms = (time.perf_counter() - t0) * 1e3 / len(r)
    r.close()
    return ms


def time_loader(out: str, native: bool, batches: int) -> dict:
    hp = dict(load_config(str(ROOT / "egs" / "soak_r5" / "conan.yaml")), binary_data_dir=out)
    saved = datasets.RecordReader
    datasets.RecordReader = functools.partial(RecordReader, use_native=native)
    try:
        it = build_train_iter(hp, "conan")
        t0 = time.perf_counter()
        stamps, rows = [], 0
        for _ in range(batches):
            rows += len(next(it)["mels"])
            stamps.append(time.perf_counter())
        it.close()
    finally:
        datasets.RecordReader = saved
    return {"wall_ms": (stamps[-1] - t0) * 1e3,
            "ms_per_batch_after_first": (stamps[-1] - stamps[0]) * 1e3 / (batches - 1),
            "rows": rows}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=256)
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--out", default=str(ROOT / "build" / "reader_bench"))
    args = ap.parse_args()
    nbytes = write_store(args.out, args.items)
    res: dict = {"items": args.items, "store_mb": nbytes / 1e6, "cpus": os.cpu_count(),
                 "item_ms": {"native": [], "python": []},
                 "loader": {"native": [], "python": []}}
    for native in (True, False, True, False):
        key = "native" if native else "python"
        res["item_ms"][key].append(time_items(args.out, native))
        res["loader"][key].append(time_loader(args.out, native, args.batches))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
