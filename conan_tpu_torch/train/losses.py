"""Training losses (``conan_tpu/train/losses.py``).

  mel L1 / MSE / SSIM           speech_base.py:223-253 and ssim.py, each over
                                the frames whose target is not all zero,
                                weighted as ``mel_losses`` says
                                ("l1:0.5|ssim:0.5")
  masked BCE with logits        the Conan UV loss, Conan.py:128-140
  multi-resolution GAN mel L1   hifigan_causal.py mel_loss:533-545, through
                                K1's GAN form (``ops.logmel.logmel_gan``)
  multi-resolution STFT         stft_loss.py: spectral convergence and
                                log-magnitude L1, the clamp under the sqrt
  LSGAN and feature matching    hifigan_causal.py:494-531
  distillation CE and accuracy  Emformer.py:15-46, over the codes that are
                                not -1

Under data parallelism (a world active, ``parallel/dist.py``) each returns
this rank's share of the global batch's loss: a plain mean is
``dist.batch_mean``, a masked mean divides by the mask summed over the ranks
(``dist.global_count``), and spectral convergence, a ratio of two norms over
the whole batch, sums both squared norms across the ranks with the gradient
(``dist.sum_across``). Alone, each is the loss of the batch it is given.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from conan_tpu_torch.audio.mel import MelConfig
from conan_tpu_torch.ops.logmel import logmel_gan
from conan_tpu_torch.ops.stft import stft_realimag
from conan_tpu_torch.parallel import dist


def weights_nonzero_speech(target: torch.Tensor) -> torch.Tensor:
    """[B, T, M] → 1 on every bin of a frame that is not all zero, else 0."""
    return (target.abs().sum(-1, keepdim=True) > 0).to(target.dtype).expand_as(target)


def mel_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    w = weights_nonzero_speech(target)
    return torch.sum(torch.abs(pred - target) * w) / dist.global_count(w.sum()).clamp(min=1.0)


def mel_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    w = weights_nonzero_speech(target)
    return (torch.sum(torch.square(pred - target) * w)
            / dist.global_count(w.sum()).clamp(min=1.0))


@functools.lru_cache(maxsize=None)
def _ssim_gauss1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """SSIM of [B, 1, H, W] images, its map's mean per batch element [B]:
    the 11-tap gaussian window (σ 1.5) is separable, so each of the five
    blurred maps is two zero-padded "same" 1-D convolutions, one per axis,
    all five in one conv per axis."""
    B = img1.shape[0]
    g = torch.from_numpy(_ssim_gauss1d(window_size)).to(img1.device, img1.dtype)
    pad = window_size // 2
    x = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2])      # [5B, 1, H, W]
    x = F.conv2d(x, g.view(1, 1, -1, 1), padding=(pad, 0))
    mu1, mu2, e11, e22, e12 = F.conv2d(x, g.view(1, 1, 1, -1), padding=(0, pad)).split(B)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1, s2, s12 = e11 - mu1_sq, e22 - mu2_sq, e12 - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return m.mean(dim=(1, 2, 3))


def mel_ssim(pred: torch.Tensor, target: torch.Tensor, bias: float = 6.0) -> torch.Tensor:
    """1 - SSIM of the mels shifted by ``bias``, per utterance, weighted by
    its count of nonzero frames × bins (not a plain mean over the batch)."""
    w = weights_nonzero_speech(target)
    loss = 1.0 - ssim(pred[:, None] + bias, target[:, None] + bias)        # [B]
    return torch.sum(loss[:, None, None] * w) / dist.global_count(w.sum()).clamp(min=1.0)


MEL_LOSSES = {"l1": mel_l1, "mse": mel_mse, "l2": mel_mse, "ssim": mel_ssim}


def parse_mel_losses(spec: str) -> dict[str, float]:
    """"l1:0.5|ssim:0.5" → {name: weight} (a name without a weight has 1)."""
    out = {}
    for part in spec.split("|"):
        if ":" in part:
            name, w = part.split(":")
            out[name] = float(w)
        else:
            out[part] = 1.0
    return out


def add_mel_losses(pred: torch.Tensor, target: torch.Tensor, spec: str, losses: dict) -> None:
    for name, lam in parse_mel_losses(spec).items():
        losses[name] = MEL_LOSSES[name](pred, target) * lam


def masked_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                           lam: float = 1.0) -> torch.Tensor:
    """Binary cross-entropy with logits, the mean over ``mask``, times ``lam``."""
    per = (torch.clamp(logits, min=0) - logits * targets
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return torch.sum(per * mask) / dist.global_count(mask.sum()).clamp(min=1.0) * lam


def _stft_mag_clamped(x: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """sqrt(max(re² + im², 1e-7)): the clamp sits under the sqrt so that the
    backward is finite at silent bins (stft_loss.py:31)."""
    re, im = stft_realimag(x, n_fft=n_fft, hop=hop, win_length=win, center=True,
                           pad_mode="reflect", at_rung=True)
    return torch.sqrt(torch.clamp(re * re + im * im, min=1e-7))


def stft_loss_single(x: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int, win: int):
    """(spectral convergence, log-magnitude L1) of prediction x against
    target y, both [B, T]."""
    xm = _stft_mag_clamped(x, n_fft, hop, win)
    ym = _stft_mag_clamped(y, n_fft, hop, win)
    sc = dist.global_share(torch.sqrt(dist.sum_across(torch.sum(torch.square(ym - xm))))
                           / torch.sqrt(dist.sum_across(torch.sum(torch.square(ym)))))
    mag = dist.batch_mean(torch.abs(torch.log(ym) - torch.log(xm)))
    return sc, mag


def multi_res_stft_loss(x: torch.Tensor, y: torch.Tensor, fft_sizes=(512, 1024, 2048),
                        hop_sizes=(160, 320, 640), win_lengths=(512, 1024, 2048)):
    sc_total, mag_total = 0.0, 0.0
    for f, h, w in zip(fft_sizes, hop_sizes, win_lengths):
        sc, mag = stft_loss_single(x, y, f, h, w)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(fft_sizes)
    return sc_total / n, mag_total / n


def gan_mel_configs(sample_rate: int = 16000, mel_bins: int = 320,
                    fft_sizes=(512, 1024, 2048), hop_sizes=(160, 160, 160),
                    win_lengths=(512, 1024, 2048)) -> list[MelConfig]:
    """One mel transform per resolution of the loss, full band."""
    return [MelConfig(sample_rate=sample_rate, n_fft=f, hop=h, win_length=w, n_mels=mel_bins,
                      fmin=0.0, fmax=sample_rate / 2)
            for f, h, w in zip(fft_sizes, hop_sizes, win_lengths)]


def multi_res_gan_mel_loss(y: torch.Tensor, y_hat: torch.Tensor, sample_rate: int = 16000,
                           mel_bins: int = 320, fft_sizes=(512, 1024, 2048),
                           hop_sizes=(160, 160, 160), win_lengths=(512, 1024, 2048),
                           lambda_mel: float = 5.0) -> torch.Tensor:
    """320-bin multi-resolution ln-mel L1 between y and y_hat, [B, T] each."""
    loss = 0.0
    for cfg in gan_mel_configs(sample_rate, mel_bins, fft_sizes, hop_sizes, win_lengths):
        loss = loss + dist.batch_mean(torch.abs(logmel_gan(y_hat, cfg) - logmel_gan(y, cfg))) \
            * lambda_mel
    return loss


def discriminator_loss(real_outs: list, fake_outs: list):
    r = sum(dist.batch_mean(torch.square(1.0 - d)) for d in real_outs) / len(real_outs)
    f = sum(dist.batch_mean(torch.square(d)) for d in fake_outs) / len(fake_outs)
    return r, f


def generator_loss(fake_outs: list) -> torch.Tensor:
    return sum(dist.batch_mean(torch.square(1.0 - d)) for d in fake_outs) / len(fake_outs)


def cond_discriminator_loss(outs: list) -> torch.Tensor:
    """Mismatched-conditioning negatives: every output is "fake"
    (hifigan_causal.py:510-516)."""
    return sum(dist.batch_mean(torch.square(d)) for d in outs) / len(outs)


def feature_loss(fmap_r: list, fmap_g: list) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + dist.batch_mean(torch.abs(rl - gl))
    return loss * 2.0


def distillation_loss(logits: torch.Tensor, codes: torch.Tensor, mask: torch.Tensor,
                      temperature: float = 1.0) -> torch.Tensor:
    """The mean over ``mask`` of -log softmax(logits / temperature)[code].
    Codes are clamped to 0 before the gather (a -1 pad gathers code 0 and is
    then masked), as the JAX package's ``take_along_axis`` reads them."""
    logp = torch.log_softmax(logits / temperature, dim=-1)
    nll = -torch.gather(logp, -1, torch.clamp(codes, min=0)[..., None])[..., 0]
    m = mask.to(logits.dtype)
    return torch.sum(nll * m) / dist.global_count(m.sum()).clamp(min=1.0)


def distillation_accuracy(logits: torch.Tensor, codes: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """The share of argmax(logits) == code over ``mask``, in fp32."""
    m = mask.to(torch.float32)
    hit = (torch.argmax(logits, dim=-1) == codes).to(torch.float32)
    return torch.sum(hit * m) / dist.global_count(m.sum()).clamp(min=1.0)
