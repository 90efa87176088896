"""Objective eval metrics (``conan_tpu/metrics/eval_metrics.py``).

numpy copies of the reference's ``utils/metrics/{dtw, pitch_distance,
diagonal_metrics, laplace_var}.py`` (offline analysis on the host) and an
SSIM metric on the training loss's ``ssim``.
"""

from __future__ import annotations

import numpy as np
import torch

from conan_tpu_torch.device import resolve_device
from conan_tpu_torch.ops.precision import precision_scope
from conan_tpu_torch.train.losses import ssim


def accelerated_dtw(x: np.ndarray, y: np.ndarray, dist: str = "euclidean", warp: int = 1):
    """DTW over a vectorized cost matrix (reference dtw.py:59-100) →
    (min distance, cost, accumulated cost, path)."""
    from scipy.spatial.distance import cdist

    if x.ndim == 1:
        x = x[:, None]
    if y.ndim == 1:
        y = y[:, None]
    r, c = len(x), len(y)
    D0 = np.zeros((r + 1, c + 1))
    D0[0, 1:] = np.inf
    D0[1:, 0] = np.inf
    D1 = D0[1:, 1:]
    D0[1:, 1:] = cdist(x, y, dist)
    C = D1.copy()
    for i in range(r):
        for j in range(c):
            min_list = [D0[i, j]]
            for k in range(1, warp + 1):
                min_list += [D0[min(i + k, r), j], D0[i, min(j + k, c)]]
            D1[i, j] += min(min_list)
    return D1[-1, -1], C, D1, _traceback(D0)


def _traceback(D: np.ndarray):
    i, j = np.array(D.shape) - 2
    p, q = [i], [j]
    while i > 0 or j > 0:
        tb = np.argmin((D[i, j], D[i, j + 1], D[i + 1, j]))
        if tb == 0:
            i -= 1
            j -= 1
        elif tb == 1:
            i -= 1
        else:
            j -= 1
        p.insert(0, i)
        q.insert(0, j)
    return np.array(p), np.array(q)


def pitch_dtw_distance(f0_a: np.ndarray, f0_b: np.ndarray) -> float:
    """DTW distance between two F0 curves (Hz) over their voiced frames, per
    frame of the longer; NaN where either has none."""
    a = f0_a[f0_a > 0]
    b = f0_b[f0_b > 0]
    if len(a) == 0 or len(b) == 0:
        return float("nan")
    d, *_ = accelerated_dtw(a[:, None], b[:, None], "euclidean")
    return float(d / max(len(a), len(b)))


# --------------------------------------------------------------------------
# attention diagonality (diagonal_metrics.py)
# --------------------------------------------------------------------------

def focus_rate(attn: np.ndarray) -> np.ndarray:
    """attn [B, Lt, Ls] → [B]."""
    return attn.max(-1).sum(-1) / attn.sum(-1).sum(-1)


def phone_coverage_rate(attn: np.ndarray) -> np.ndarray:
    return attn.max(1).sum(-1) / attn.shape[-1]


def diagonal_focus_rate(attn: np.ndarray, attn_ks: np.ndarray, target_len: np.ndarray,
                        band_mask_factor: float = 5, band_width: float = 50):
    width = np.minimum(target_len / band_mask_factor, band_width).astype(float)
    B, Lt, Ls = attn.shape
    x = np.arange(Lt)[None, :, None].astype(float)
    y = np.arange(Ls)[None, None, :].astype(float)
    cond = y - attn_ks[:, None, None] * x
    k_w = attn_ks[:, None, None] * width[:, None, None]
    mask = ((cond + k_w >= 0) & (cond - k_w <= 0)).astype(float)
    diag = (attn * mask).sum((-1, -2))
    return diag / attn.sum((-1, -2)), mask


def laplace_var(x: np.ndarray) -> float:
    import scipy.ndimage

    return float(scipy.ndimage.laplace(x).var())


def mel_ssim_metric(pred: np.ndarray, target: np.ndarray, device=None) -> float:
    """Mean SSIM of two [T, M] mels shifted by 6 (the training loss's SSIM,
    fp32, TF32 off) on ``device`` (None: the card)."""
    dev = resolve_device(device)
    p = torch.from_numpy(np.asarray(pred, np.float32))[None, None].to(dev) + 6.0
    t = torch.from_numpy(np.asarray(target, np.float32))[None, None].to(dev) + 6.0
    with precision_scope("exact", dev):
        return float(ssim(p, t)[0])
