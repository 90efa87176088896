"""F0 quantization and (de-)normalization (``conan_tpu/audio/pitch.py``).
``norm_interp_f0_np`` is the numpy helper the datasets run on the host."""

from __future__ import annotations

import numpy as np
import torch

F0_BIN = 256
F0_MAX = 900.0
F0_MIN = 50.0


def f0_to_coarse(f0_denorm: torch.Tensor, f0_bin: int = F0_BIN, f0_max: float = F0_MAX,
                 f0_min: float = F0_MIN) -> torch.Tensor:
    """Hz → [1, f0_bin-1] integer bins."""
    f0_mel_min = float(1127 * np.log(1 + f0_min / 700))
    f0_mel_max = float(1127 * np.log(1 + f0_max / 700))
    f0_mel = 1127 * torch.log(1 + f0_denorm / 700)
    scaled = (f0_mel - f0_mel_min) * (f0_bin - 2) / (f0_mel_max - f0_mel_min) + 1
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = torch.clamp(f0_mel, 1, f0_bin - 1)
    return torch.floor(f0_mel + 0.5).long()


def coarse_to_f0(f0_coarse: torch.Tensor, f0_bin: int = F0_BIN, f0_max: float = F0_MAX,
                 f0_min: float = F0_MIN) -> torch.Tensor:
    """[1, f0_bin-1] bins → Hz (bin 1 is 0 Hz, unvoiced)."""
    f0_mel_min = float(1127 * np.log(1 + f0_min / 700))
    f0_mel_max = float(1127 * np.log(1 + f0_max / 700))
    f0 = f0_mel_min + (f0_coarse - 1) * (f0_mel_max - f0_mel_min) / (f0_bin - 2)
    f0 = (torch.exp(f0 / 1127) - 1) * 700
    return torch.where(f0_coarse == 1, 0.0, f0)


def norm_f0(f0: torch.Tensor, uv: torch.Tensor | None) -> torch.Tensor:
    """log2(f0 + 1e-8), 0 where unvoiced."""
    f0 = torch.log2(f0 + 1e-8)
    if uv is not None:
        f0 = torch.where(uv > 0, 0.0, f0)
    return f0


def norm_interp_f0_np(f0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host side: log2-normalize and interpolate linearly through the
    unvoiced (zero) gaps. Returns (f0, uv), float32."""
    uv = f0 == 0
    f0 = np.log2(f0 + 1e-8)
    f0[uv] = 0
    if uv.sum() == len(f0):
        f0[uv] = 0
    elif uv.sum() > 0:
        f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])
    return f0.astype(np.float32), uv.astype(np.float32)


def denorm_f0(f0: torch.Tensor, uv: torch.Tensor | None, *, f0_min: float = 50.0,
              f0_max: float = 900.0) -> torch.Tensor:
    """2**f0 then clamp; zero where unvoiced."""
    f0 = torch.clamp(torch.exp2(f0), f0_min, f0_max)
    if uv is not None:
        f0 = torch.where(uv > 0, torch.zeros_like(f0), f0)
    return f0
