"""Spectral-subtraction denoise after the vocoder (``conan_tpu/audio/denoise.py``),
applied when the acoustic config sets ``vocoder_denoise_c > 0``.

The waveform goes through the STFT, each bin's magnitude is lowered by a
constant ``v`` (floored at 0, phase kept), and the inverse STFT brings it
back: inverse rDFT per frame, synthesis window, overlap-add, divided by the
overlap-added squared window (librosa's ``istft``). Both transforms are
framed matmuls (``ops/stft.py``), plain torch on every device: the JAX
package has no Pallas kernel here either.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from conan_tpu_torch.ops.stft import _window_np, overlap_add, stft_realimag


@functools.lru_cache(maxsize=None)
def _idft_kernel_np(n_fft: int) -> np.ndarray:
    """[2·n_bins, n_fft] inverse rDFT basis: x[t] = (1/n)·Σ_k c_k(re_k cosθ −
    im_k sinθ), c_k = 2 except DC and Nyquist (conjugate-symmetric half
    spectrum)."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[None, :]
    k = np.arange(n_bins)[:, None]
    angle = 2.0 * np.pi * k * t / n_fft
    c = np.full((n_bins, 1), 2.0)
    c[0] = 1.0
    if n_fft % 2 == 0:
        c[-1] = 1.0
    basis = np.concatenate([c * np.cos(angle), -c * np.sin(angle)], axis=0)
    return (basis / n_fft).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _win_sumsquare_np(n_fft: int, hop: int, win_length: int, n_frames: int) -> np.ndarray:
    """Overlap-added squared synthesis window (librosa ``window_sumsquare``),
    floored at a tiny value where no window covers a sample."""
    w2 = _window_np(n_fft, win_length).astype(np.float32).astype(np.float64) ** 2
    out = np.zeros(n_fft + (n_frames - 1) * hop)
    for f in range(n_frames):
        out[f * hop:f * hop + n_fft] += w2
    return np.maximum(out, 1e-10).astype(np.float32)


def istft_realimag(spec_ri: torch.Tensor, *, n_fft: int, hop: int,
                   win_length: int | None = None, center: bool = True,
                   length: int | None = None) -> torch.Tensor:
    """Inverse of the framed STFT: [B, F, 2·n_bins] (re ∥ im) → [B, T]. T is
    ``(F-1)·hop`` for ``center=True`` (librosa's default), or ``length``
    (cropped or zero-padded)."""
    win_length = win_length or n_fft
    F_ = spec_ri.shape[1]
    dev = spec_ri.device
    basis = torch.from_numpy(_idft_kernel_np(n_fft)).to(dev)
    window = torch.from_numpy(_window_np(n_fft, win_length).astype(np.float32)).to(dev)
    frames = (spec_ri @ basis) * window
    t_total = n_fft + (F_ - 1) * hop
    sig = overlap_add(frames, hop, t_total)
    sig = sig / torch.from_numpy(_win_sumsquare_np(n_fft, hop, win_length, F_)).to(dev)
    if center:
        sig = sig[:, n_fft // 2: t_total - n_fft // 2]
    if length is None:
        return sig
    if sig.shape[1] >= length:
        return sig[:, :length]
    return F.pad(sig, (0, length - sig.shape[1]))


def spectral_denoise(wav: torch.Tensor, *, v: float, n_fft: int, hop: int,
                     win_length: int | None = None) -> torch.Tensor:
    """|X| ← max(|X| − v, 0), phase kept. ``wav`` [B, T] → [B, (T//hop)·hop]
    (librosa's default istft length for a centred stft)."""
    win_length = win_length or n_fft
    re, im = stft_realimag(wav, n_fft=n_fft, hop=hop, win_length=win_length, center=True,
                           pad_mode="constant")
    mag = torch.sqrt(re * re + im * im)
    scale = torch.clamp(mag - v, min=0.0) / torch.clamp(mag, min=1e-12)
    return istft_realimag(torch.cat([re * scale, im * scale], dim=-1), n_fft=n_fft, hop=hop,
                          win_length=win_length, center=True)
