"""STFT constants and the framed-DFT magnitude (``conan_tpu/ops/stft.py``).

The windowed DFT basis and the librosa mel filterbank are built in numpy, the
same arithmetic as the JAX package, so the port's plain path, its CUDA kernel
and the JAX package all use identical constants. Framing is ``unfold``, whose
autograd is the overlap-add; ``overlap_add`` is the same sum written out, for
the log-mel kernel's analytic backward.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from conan_tpu_torch.ops.precision import dot_at_rung


def _window_np(n_fft: int, win_length: int) -> np.ndarray:
    """[n_fft] float64 periodic Hann window of ``win_length``, zero-padded
    symmetrically to n_fft like torch.stft when win_length < n_fft."""
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    w_full = np.zeros(n_fft)
    off = (n_fft - win_length) // 2
    w_full[off:off + win_length] = window
    return w_full


@functools.lru_cache(maxsize=None)
def _dft_kernel_np(n_fft: int, win_length: int) -> np.ndarray:
    """[n_fft, 2*n_bins] windowed DFT basis: real columns then imaginary.

    X_k = sum_t w[t] x[t] exp(-2πi k t / n_fft), w = ``_window_np``.
    """
    n_bins = n_fft // 2 + 1
    w_full = _window_np(n_fft, win_length)
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = 2.0 * np.pi * t * k / n_fft
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=1)
    return (w_full[:, None] * basis).astype(np.float32)


def frame_count(n_samples: int, n_fft: int, hop: int, center: bool) -> int:
    if center:
        return n_samples // hop + 1
    return (n_samples - n_fft) // hop + 1


def stft_realimag(wav: torch.Tensor, *, n_fft: int, hop: int,
                  win_length: int | None = None, center: bool = True,
                  pad_mode: str = "constant",
                  at_rung: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """STFT of ``wav`` [B, T] → (re, im), each [B, frames, n_bins]: framing by
    ``unfold``, then one [.., n_fft] @ [n_fft, 2·n_bins] matmul, at the
    training rung with ``at_rung`` (the STFT loss's, as JAX's
    ``_framed_dft`` reads the precision; K1's plain version stays fp32)."""
    win_length = win_length or n_fft
    if center:
        p = n_fft // 2
        wav = F.pad(wav[:, None], (p, p), mode=pad_mode)[:, 0]
    basis = torch.from_numpy(_dft_kernel_np(n_fft, win_length)).to(wav.device, wav.dtype)
    frames = wav.unfold(-1, n_fft, hop)
    ri = dot_at_rung(torch.matmul, frames, basis) if at_rung else frames @ basis  # [B, F, 2·n_bins]
    n_bins = n_fft // 2 + 1
    return ri[..., :n_bins], ri[..., n_bins:]


def stft_magnitude(wav: torch.Tensor, *, n_fft: int, hop: int,
                   win_length: int | None = None, center: bool = True,
                   pad_mode: str = "constant", eps_under_sqrt: float = 0.0) -> torch.Tensor:
    """|STFT| of ``wav`` [B, T] → [B, frames, n_bins], sqrt(re² + im² + eps)."""
    re, im = stft_realimag(wav, n_fft=n_fft, hop=hop, win_length=win_length,
                           center=center, pad_mode=pad_mode)
    return torch.sqrt(re * re + im * im + eps_under_sqrt)


def overlap_add(frames: torch.Tensor, hop: int, n_samples: int) -> torch.Tensor:
    """Transpose of ``unfold`` framing: [B, F, n_fft] → [B, n_samples], each
    frame added in at f·hop."""
    n_fft = frames.shape[-1]
    out = F.fold(frames.transpose(1, 2), output_size=(1, n_samples), kernel_size=(1, n_fft),
                 stride=(1, hop))
    return out[:, 0, 0]


# ---------------------------------------------------------------------------
# librosa-compatible mel filterbank (slaney norm, non-htk)
# ---------------------------------------------------------------------------

def _hz_to_mel(f, htk: bool = False):
    if htk:
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):  # f=0 falls in the linear branch of the where
        return np.where(
            f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mels)


def _mel_to_hz(m, htk: bool = False):
    if htk:
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def mel_filterbank_np(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
                      htk: bool = False, norm: str | None = "slaney") -> np.ndarray:
    """Reimplementation of ``librosa.filters.mel`` defaults → [n_mels, n_bins]."""
    n_bins = n_fft // 2 + 1
    fftfreqs = np.linspace(0, sr / 2, n_bins)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2), htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)
