"""Datasets over the binary record store (``conan_tpu/data/datasets.py``).

  SpeechDataset   an item's mel, a reference mel of another utterance of the
                  same speaker (through ``<prefix>_spk_ids.npy``), its
                  speaker id, its F0 log-normalized with the unvoiced gaps
                  interpolated, and with ``use_spk_embed`` its
                  pre-extracted ``spk_embed`` where the record has one
  ConanDataset    + the content codes; ``collate`` pads codes with -1 (the
                  value the model masks), mels, F0 and UV with 0
  EmformerDataset + the content codes; ``collate`` pads mels to whole
                  segments plus the right-context lookahead, and masks to -1
                  the codes with no real lookahead
  VocoderDataset  random crops of ``max_samples`` // hop frames and their wav

Sizes come from ``<prefix>_lengths.npy``. Random choices (references, crops)
come from a numpy generator seeded as the JAX package's, so both give the
same batches.

An item is ``load(plan(i))``: ``plan`` makes the item's random choices and
gives its lengths from the sizes, without reading it; ``load`` reads it. A
rank under data parallelism plans every item of the global batch, so that
its generator advances as on one rank and the batch's length rung is the
global one, and loads only its own rows (``data/loader.py``).
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
        self._spk_ids = None

    def __len__(self) -> int:
        return len(self.avail_idxs)

    def _get_item(self, local_idx: int):
        if self._reader is None:
            self._reader = RecordReader(f"{self.data_dir}/{self.prefix}")
        return self._reader[self.avail_idxs[local_idx]]

    def _spk_of(self, local_idx: int) -> int:
        """An item's speaker id, from ``<prefix>_spk_ids.npy`` where it
        exists, else from the item."""
        if self._spk_ids is None:
            path = f"{self.data_dir}/{self.prefix}_spk_ids.npy"
            self._spk_ids = (np.asarray(np.load(path, mmap_mode="r"))[self.avail_idxs]
                             if os.path.exists(path) else False)
        if self._spk_ids is False:
            return int(self._get_item(local_idx)["spk_id"])
        return int(self._spk_ids[local_idx])

    def _speaker_map(self) -> dict[int, list[int]]:
        """speaker id → up to ``max_samples_per_spk`` local indices, in a
        seeded random order."""
        if self._spk2indices is None:
            self._spk2indices = defaultdict(list)
            max_per = int(self.hp.get("max_samples_per_spk", 100))
            for li in self.rng.permutation(len(self)):
                b = self._spk2indices[self._spk_of(li)]
                if len(b) < max_per:
                    b.append(int(li))
        return self._spk2indices

    def plan(self, index: int) -> dict:
        """The item's reference (another utterance of its speaker, drawn
        from the generator) and the frames of both after the ``max_frames``
        cut, from the sizes."""
        cands = [li for li in self._speaker_map()[self._spk_of(index)] if li != index]
        ref = int(self.rng.choice(cands)) if cands else index
        max_frames = self.hp.get("max_frames", 3000)
        return {"index": index, "ref": ref, "frames": min(self.sizes[index], max_frames),
                "ref_frames": min(self.sizes[ref], max_frames)}

    def __getitem__(self, index: int) -> dict:
        return self.load(self.plan(index))

    def load(self, plan: dict) -> dict:
        hp = self.hp
        index = plan["index"]
        item = self._get_item(index)
        max_frames = hp.get("max_frames", 3000)
        mel = np.asarray(item["mel"], np.float32)[:max_frames]
        spk_id = int(item["spk_id"])
        ref_mel = np.asarray(self._get_item(plan["ref"])["mel"], np.float32)[:max_frames]
        sample = {"id": index, "item_name": item.get("item_name", str(index)),
                  "mel": mel, "ref_mel": ref_mel, "spk_id": spk_id}
        if hp.get("use_spk_embed", False) and "spk_embed" in item:
            emb = item["spk_embed"]
            if isinstance(emb, str):        # metadata stores space-separated floats
                emb = [float(x) for x in emb.split()]
            sample["spk_embed"] = np.asarray(emb, np.float32)
        if "f0" in item:
            T = min(mel.shape[0], len(item["f0"]))
            sample["mel"] = mel[:T]
            sample["f0"], sample["uv"] = norm_interp_f0_np(
                np.asarray(item["f0"], np.float32)[:T].copy())
        return sample


class ConanDataset(SpeechDataset):
    def load(self, plan: dict) -> dict:
        sample = super().load(plan)
        content = np.asarray(self._get_item(plan["index"])["hubert"], np.int64)
        T = min(len(content), sample["mel"].shape[0])
        sample["content"] = content[:T]
        sample["mel"] = sample["mel"][:T]
        if "f0" in sample:
            sample["f0"] = sample["f0"][:T]
            sample["uv"] = sample["uv"][:T]
        return sample

    def collate(self, samples: list[dict], target_len: int | None = None,
                ref_target_len: int | None = None) -> dict:
        """Pads as the module's docstring says; ``spk_embed`` [B, H] where
        every sample has one (``use_spk_embed``)."""
        batch = {
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
        if all("spk_embed" in s for s in samples):
            batch["spk_embed"] = np.stack([s["spk_embed"] for s in samples])
        return batch


class EmformerDataset(SpeechDataset):
    """mel and the teacher's codes (tasks/Emformer/dataset.py). Its items
    still draw a same-speaker reference, as every SpeechDataset's do, so the
    generator's later draws stay the JAX package's."""

    def load(self, plan: dict) -> dict:
        sample = super().load(plan)
        content = np.asarray(self._get_item(plan["index"])["hubert"], np.int64)
        T = min(len(content), sample["mel"].shape[0])
        sample["content"] = content[:T]
        sample["mel"] = sample["mel"][:T]
        return sample

    def collate(self, samples: list[dict], target_len: int | None = None,
                seg: int = 4, rc: int = 2) -> dict:
        """mels padded with 0 to ⌈T/seg⌉·seg + rc frames (T the target length,
        else the longest mel), content codes with -1 to ⌈T/seg⌉·seg. The last
        ``rc`` codes of every sample (after the crop to ⌈T/seg⌉·seg + rc) are
        -1 too: their lookahead would read padding, not audio (the
        reference's ``content[:, :-right_context]`` cut, made per sample)."""
        T = target_len or max(s["mel"].shape[0] for s in samples)
        T_utt = -(-T // seg) * seg
        contents = []
        for s in samples:
            c = np.asarray(s["content"]).copy()
            if rc > 0:
                c[max(min(len(c), T_utt + rc) - rc, 0):] = -1
            contents.append(c)
        return {"nsamples": len(samples),
                "mels": collate_2d([s["mel"] for s in samples], 0.0, T_utt + rc),
                "content": collate_1d(contents, -1, T_utt)}


class VocoderDataset:
    """Items longer than ``max_samples`` // hop frames; ``collate`` cuts a
    random crop of that many frames and the matching wav from each (from
    each item not cut already: ``load(plan(i))`` cuts the crop that ``plan``
    drew)."""

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

    def plan(self, index: int) -> dict:
        """The item's crop start, drawn as ``collate`` draws it."""
        return {"index": index,
                "start": int(self.rng.integers(0, self.sizes[index] - self.batch_max_frames))}

    def load(self, plan: dict) -> dict:
        return self._crop(self[plan["index"]], plan["start"])

    def _crop(self, s: dict, start: int) -> dict:
        mf = self.batch_max_frames
        return {"mel": s["mel"][start:start + mf],
                "wav": s["wav"][start * self.hop:(start + mf) * self.hop], "start": start}

    def collate(self, samples: list[dict]) -> dict:
        mf = self.batch_max_frames
        mels, wavs = [], []
        for s in samples:
            if "start" not in s:
                if len(s["mel"]) <= mf:
                    continue
                s = self._crop(s, int(self.rng.integers(0, len(s["mel"]) - mf)))
            mels.append(s["mel"])
            wavs.append(s["wav"])
        return {"mels": np.stack(mels), "wavs": np.stack(wavs)}
