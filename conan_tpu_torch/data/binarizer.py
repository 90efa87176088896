"""Wav loading (``conan_tpu/data/binarizer.py``: ``load_wav``). The
binarizer itself waits for the data-preparation slice."""

from __future__ import annotations

import numpy as np


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
