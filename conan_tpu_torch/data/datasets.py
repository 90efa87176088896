"""Datasets over the binary record store (``conan_tpu/data/datasets.py``).

  SpeechDataset   an item's mel, a reference mel of another utterance of the
                  same speaker (through ``<prefix>_spk_ids.npy``), and its F0
                  log-normalized with the unvoiced gaps interpolated
  ConanDataset    + the content codes; ``collate`` pads codes with -1 (the
                  value the model masks), mels, F0 and UV with 0
  VocoderDataset  random crops of ``max_samples`` // hop frames and their wav

Sizes come from ``<prefix>_lengths.npy``. Random choices (references, crops)
come from a numpy generator seeded as the JAX package's, so both give the
same batches.
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from conan_tpu_torch.audio.pitch import norm_interp_f0_np
from conan_tpu_torch.data.batching import collate_1d, collate_2d
from conan_tpu_torch.data.record_store import RecordReader


class SpeechDataset:
    def __init__(self, data_dir: str, prefix: str, hp, seed: int = 1234):
        self.data_dir = data_dir
        self.prefix = prefix
        self.hp = hp
        self.rng = np.random.default_rng(seed)
        sizes = np.load(f"{data_dir}/{prefix}_lengths.npy")
        self.avail_idxs = list(range(len(sizes)))
        min_frames = hp.get("min_frames", 0)
        if prefix == "train" and min_frames > 0:
            self.avail_idxs = [i for i in self.avail_idxs if sizes[i] >= min_frames]
        self.sizes = [int(sizes[i]) for i in self.avail_idxs]
        self._reader: RecordReader | None = None
        self._spk2indices: dict[int, list[int]] | None = None

    def __len__(self) -> int:
        return len(self.avail_idxs)

    def _get_item(self, local_idx: int):
        if self._reader is None:
            self._reader = RecordReader(f"{self.data_dir}/{self.prefix}")
        return self._reader[self.avail_idxs[local_idx]]

    def _speaker_map(self) -> dict[int, list[int]]:
        """speaker id → up to ``max_samples_per_spk`` local indices, in a
        seeded random order; from ``<prefix>_spk_ids.npy`` where it exists,
        else from the items."""
        if self._spk2indices is None:
            self._spk2indices = defaultdict(list)
            max_per = int(self.hp.get("max_samples_per_spk", 100))
            path = f"{self.data_dir}/{self.prefix}_spk_ids.npy"
            if os.path.exists(path):
                local = np.asarray(np.load(path, mmap_mode="r"))[self.avail_idxs]
                spk_of = lambda li: int(local[li])  # noqa: E731
            else:
                spk_of = lambda li: int(self._get_item(li)["spk_id"])  # noqa: E731
            for li in self.rng.permutation(len(self)):
                b = self._spk2indices[spk_of(li)]
                if len(b) < max_per:
                    b.append(int(li))
        return self._spk2indices

    def __getitem__(self, index: int) -> dict:
        hp = self.hp
        item = self._get_item(index)
        max_frames = hp.get("max_frames", 3000)
        mel = np.asarray(item["mel"], np.float32)[:max_frames]
        spk_id = int(item["spk_id"])
        cands = [li for li in self._speaker_map()[spk_id] if li != index]
        ref_local = int(self.rng.choice(cands)) if cands else index
        ref_mel = np.asarray(self._get_item(ref_local)["mel"], np.float32)[:max_frames]
        sample = {"id": index, "item_name": item.get("item_name", str(index)),
                  "mel": mel, "ref_mel": ref_mel, "spk_id": spk_id}
        if "f0" in item:
            T = min(mel.shape[0], len(item["f0"]))
            sample["mel"] = mel[:T]
            sample["f0"], sample["uv"] = norm_interp_f0_np(
                np.asarray(item["f0"], np.float32)[:T].copy())
        return sample


class ConanDataset(SpeechDataset):
    def __getitem__(self, index: int) -> dict:
        sample = super().__getitem__(index)
        content = np.asarray(self._get_item(index)["hubert"], np.int64)
        T = min(len(content), sample["mel"].shape[0])
        sample["content"] = content[:T]
        sample["mel"] = sample["mel"][:T]
        if "f0" in sample:
            sample["f0"] = sample["f0"][:T]
            sample["uv"] = sample["uv"][:T]
        return sample

    def collate(self, samples: list[dict], target_len: int | None = None,
                ref_target_len: int | None = None) -> dict:
        return {
            "nsamples": len(samples),
            "item_name": [s["item_name"] for s in samples],
            "content": collate_1d([s["content"] for s in samples], -1, target_len),
            "mels": collate_2d([s["mel"] for s in samples], 0.0, target_len),
            "ref_mels": collate_2d([s["ref_mel"] for s in samples], 0.0, ref_target_len),
            "f0": collate_1d([s["f0"] for s in samples], 0.0, target_len),
            "uv": collate_1d([s["uv"] for s in samples], 0.0, target_len),
            "mel_lengths": np.asarray([s["mel"].shape[0] for s in samples], np.int64),
            "spk_ids": np.asarray([s["spk_id"] for s in samples], np.int64),
        }


class VocoderDataset:
    """Items longer than ``max_samples`` // hop frames; ``collate`` cuts a
    random crop of that many frames and the matching wav from each."""

    def __init__(self, data_dir: str, prefix: str, hp, seed: int = 1234):
        self.data_dir = data_dir
        self.prefix = prefix
        self.rng = np.random.default_rng(seed)
        self.hop = hp["hop_size"]
        self.batch_max_frames = hp.get("max_samples", 8192) // self.hop
        sizes = np.load(f"{data_dir}/{prefix}_lengths.npy")
        self.avail_idxs = [i for i, n in enumerate(sizes) if n > self.batch_max_frames]
        self.sizes = [int(sizes[i]) for i in self.avail_idxs]
        self._reader: RecordReader | None = None

    def __len__(self) -> int:
        return len(self.avail_idxs)

    def __getitem__(self, index: int) -> dict:
        if self._reader is None:
            self._reader = RecordReader(f"{self.data_dir}/{self.prefix}")
        item = self._reader[self.avail_idxs[index]]
        return {"mel": np.asarray(item["mel"], np.float32),
                "wav": np.asarray(item["wav"], np.float32)}

    def collate(self, samples: list[dict]) -> dict:
        mf = self.batch_max_frames
        mels, wavs = [], []
        for s in samples:
            c, x = s["mel"], s["wav"]
            if len(c) <= mf:
                continue
            start = int(self.rng.integers(0, len(c) - mf))
            mels.append(c[start:start + mf])
            wavs.append(x[start * self.hop:(start + mf) * self.hop])
        return {"mels": np.stack(mels), "wavs": np.stack(wavs)}
