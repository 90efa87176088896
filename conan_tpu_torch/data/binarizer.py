"""Data preparation for the Conan acoustic model
(``conan_tpu/data/binarizer.py``): ``metadata.json`` → a binary record store.

``ConanBinarizer.process`` splits the items by speaker prefix
(``split_items``), and writes per split ``<binary_data_dir>/<prefix>``
records ``{item_name, mel, wav, hubert, spk_id, len, f0}`` with every stream
cut to their common length, beside ``<prefix>_lengths.npy`` and
``<prefix>_spk_ids.npy``. The content codes come pre-extracted in the
metadata (space-separated); F0 from ``<wav dir>_f0/<name>_f0.npy`` (zeros,
with a warning, where it is missing). Each mel is one call of the serving
log-mel frontend, kernel K1 on the card (``device`` None) or its plain
version on the CPU. An item whose files cannot be read is skipped with a
warning; an error of the frontend is not caught.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

from conan_tpu_torch.audio.mel import MelConfig, wav2mel_frontend
from conan_tpu_torch.data.record_store import RecordWriter
from conan_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)


def load_wav(path: str, sample_rate: int) -> np.ndarray:
    """16-bit, 32-bit or float wav → float32 mono, with no resampling (the
    file must be at ``sample_rate`` already, as the data preparation makes
    it); raises ValueError otherwise."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if sr != sample_rate:
        raise ValueError(f"{path}: sample rate {sr} != {sample_rate} (resample offline)")
    return data


def split_items(item_names: list[str], valid_prefixes, test_prefixes):
    """(train, test, valid) by speaker prefix: an item whose name holds a
    valid or test prefix goes there, every other one to train."""
    test = [x for x in item_names if any(p in x for p in test_prefixes)]
    valid = [x for x in item_names if any(p in x for p in valid_prefixes)]
    held_out = set(test) | set(valid)
    return [x for x in item_names if x not in held_out], test, valid


class ConanBinarizer:
    def __init__(self, hp, device: str | torch.device | None = None):
        self.hp = hp
        self.device = resolve_device(device)
        self.mel_cfg = MelConfig.from_hparams(hp)
        self.processed_dir = hp["processed_data_dir"]
        self.binary_dir = hp["binary_data_dir"]
        spk_path = os.path.join(self.processed_dir, "spker_set.json")
        self.spker_map = {}
        if os.path.exists(spk_path):
            with open(spk_path) as f:
                self.spker_map = json.load(f)

    def load_metadata(self) -> dict[str, dict]:
        for name in ("metadata.json", "metadata_vctk_librittsr_gt.json",
                     "example_metadata.json"):
            path = os.path.join(self.processed_dir, name)
            if os.path.exists(path):
                with open(path) as f:
                    return {r["item_name"]: r for r in json.load(f)}
        raise FileNotFoundError(f"no metadata json in {self.processed_dir}")

    def read_item(self, item: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
        """The reads that may fail on a bad item: its wav, its content codes
        and its F0 contour (None where ``<wav dir>_f0/<name>_f0.npy`` is
        missing). Raise OSError or ValueError on an unreadable one."""
        wav_fn = item["wav_fn"]
        wav = load_wav(wav_fn, self.hp["audio_sample_rate"])
        hubert = item["hubert"]
        content = (np.asarray([float(x) for x in hubert.split()], np.int64)
                   if isinstance(hubert, str) else np.asarray(hubert, np.int64))
        f0_path = os.path.join(os.path.dirname(wav_fn) + "_f0",
                               os.path.basename(wav_fn).replace(".wav", "_f0.npy"))
        return wav, content, np.load(f0_path) if os.path.exists(f0_path) else None

    def process_item(self, item: dict, wav: np.ndarray, content: np.ndarray,
                     f0: np.ndarray | None) -> dict:
        """The record of one item from what ``read_item`` read: its mel from
        the log-mel frontend, every stream cut to their common length."""
        hp = self.hp
        mel = wav2mel_frontend(torch.from_numpy(wav[None]).to(self.device),
                               self.mel_cfg)[0].cpu().numpy()
        if f0 is None:
            log.warning("no f0 for %s: storing zeros", item["item_name"])
            f0 = np.zeros(mel.shape[0], np.float32)
        n = min(len(content), mel.shape[0], len(f0))
        return {"item_name": item["item_name"], "mel": mel[:n].astype(np.float32),
                "wav": wav[:n * hp["hop_size"]].astype(np.float32), "hubert": content[:n],
                "spk_id": int(self.spker_map.get(item["item_name"].split("_", 1)[0], 0)),
                "len": int(n), "f0": np.asarray(f0[:n], np.float32)}

    def process(self) -> None:
        items = self.load_metadata()
        train, test, valid = split_items(list(items), self.hp.get("valid_prefixes", ()),
                                         self.hp.get("test_prefixes", ()))
        os.makedirs(self.binary_dir, exist_ok=True)
        for prefix, names in (("valid", valid), ("test", test), ("train", train)):
            writer = RecordWriter(f"{self.binary_dir}/{prefix}")
            lengths, spk_ids = [], []
            for name in names:
                try:
                    read = self.read_item(items[name])
                except (OSError, ValueError) as e:   # an unreadable item is skipped
                    log.warning("skip %s: %s", name, e)
                    continue
                # the frontend's errors (K1 refusing an input) propagate
                rec = self.process_item(items[name], *read)
                writer.add_item(rec)
                lengths.append(rec["len"])
                spk_ids.append(rec["spk_id"])
            writer.finalize()
            np.save(f"{self.binary_dir}/{prefix}_lengths.npy", np.asarray(lengths))
            np.save(f"{self.binary_dir}/{prefix}_spk_ids.npy", np.asarray(spk_ids))
            log.info("%s: %d items", prefix, len(lengths))
