"""The port's log-mel, kernel K1's plain versions and wrappers in both forms
(serving and GAN loss), against the JAX package: the XLA path and the Pallas
kernel in interpret mode; and, on the CPU, what surrounds the CUDA kernel:
its band tables, window and twiddles, and its FFT's arithmetic emulated in
numpy from those tables.

Tolerance atol 2e-4, rtol 1e-4, as tests/test_pallas_stft.py holds the Pallas
kernel to the XLA path: both sides are fp32 over the same constants, and
only the order of the sums differs (log of mel sums of n_fft-term DFTs). The
GAN form's gradients: atol 5e-4, rtol 1e-3 (the bound
tests/test_pallas_groupconv.py holds gradients to), the sums of the
backward's two DFT products in other orders.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import jax

from conan_tpu.audio.mel import MelConfig, wav2mel_gan, wav2mel_librosa
from conan_tpu.ops import stft as jax_stft
from conan_tpu.ops.pallas_stft import pallas_wav2mel_gan_diff, pallas_wav2mel_librosa

from conan_tpu_torch.audio.mel import MelConfig as PortMelConfig
from conan_tpu_torch.audio.mel import wav2mel_frontend
from conan_tpu_torch.audio.mel import wav2mel_gan as port_wav2mel_gan
from conan_tpu_torch.ops import stft as port_stft
from conan_tpu_torch.ops.logmel import (LogmelGanKernel, LogmelKernel, _LogmelGanFunction,
                                        _mel_bands_np, _twiddles_np, gan_pad, logmel,
                                        logmel_gan, logmel_gan_reference, logmel_reference)
from tests.torch_port_util import one_torch_thread  # noqa: F401

ATOL, RTOL = 2e-4, 1e-4
HOP = 320


# 51 frames; 128 frames (exactly one 128-frame Pallas tile); 129 frames (one
# frame into a second tile); two streams of 3 s
@pytest.mark.parametrize("shape", [(1, 16000), (1, 127 * HOP), (1, 128 * HOP + 17),
                                   (2, 48000)])
def test_logmel_reference_matches_jax_xla_and_pallas(shape):
    rng = np.random.default_rng(sum(shape))
    wav = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    got = logmel_reference(torch.from_numpy(wav), PortMelConfig()).numpy()
    xla = np.asarray(wav2mel_librosa(jnp.asarray(wav), MelConfig()))
    assert got.shape == xla.shape == (shape[0], shape[1] // HOP + 1, 80)
    np.testing.assert_allclose(got, xla, atol=ATOL, rtol=RTOL)
    if shape[1] <= 128 * HOP + 17:   # the Pallas interpreter is slow on long inputs
        pallas = np.asarray(pallas_wav2mel_librosa(jnp.asarray(wav), MelConfig(),
                                                   interpret=True))
        np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)


def test_constants_equal_jax():
    """The DFT basis and the filterbank are the same numpy arithmetic."""
    np.testing.assert_array_equal(port_stft._dft_kernel_np(1024, 1024),
                                  jax_stft._dft_kernel_np(1024, 1024))
    np.testing.assert_array_equal(port_stft.mel_filterbank_np(16000, 1024, 80, 80.0, 7600.0),
                                  jax_stft.mel_filterbank_np(16000, 1024, 80, 80.0, 7600.0))


def test_cpu_tensor_takes_plain_path_without_launch():
    kernel = LogmelKernel()
    wav = torch.from_numpy((np.random.default_rng(1).standard_normal((1, 8000)) * 0.2)
                           .astype(np.float32))
    out = kernel(wav, PortMelConfig())
    assert kernel.launches == 0
    torch.testing.assert_close(out, logmel_reference(wav, PortMelConfig()), rtol=0, atol=0)
    before = logmel.launches
    wav2mel_frontend(wav, PortMelConfig())
    assert logmel.launches == before


def test_other_devices_raise():
    with pytest.raises(ValueError, match="no kernel"):
        LogmelKernel()(torch.empty(1, 8000, device="meta"), PortMelConfig())


# the GAN loss's three resolutions (egs/hifigan_shuffle.yaml mel_loss_param)
GAN_CFGS = [dict(sample_rate=16000, n_fft=f, hop=160, win_length=f, n_mels=320, fmin=0.0,
                 fmax=8000.0) for f in (512, 1024, 2048)]
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3


def _sin_sum_grad(fn, wav):
    w = torch.from_numpy(wav).requires_grad_(True)
    mel = fn(w)
    torch.sin(mel).sum().backward()
    return mel.detach().numpy(), w.grad.numpy()


@pytest.mark.parametrize("cfg", GAN_CFGS, ids=lambda c: f"n_fft{c['n_fft']}")
def test_logmel_gan_matches_jax_xla_and_pallas(cfg):
    """The plain GAN form (the CPU route) and the autograd Function (plain
    forward, analytic backward) against JAX's wav2mel_gan and its Pallas
    form with the analytic VJP, in value and in the gradient of
    sum(sin(mel)); 1.5 s of a clipped wav at B = 2 (the loss's 50 frames)."""
    rng = np.random.default_rng(cfg["n_fft"])
    wav = np.clip(rng.standard_normal((2, 8000)) * 0.4, -1.2, 1.2).astype(np.float32)
    jcfg, pcfg = MelConfig(**cfg), PortMelConfig(**cfg)

    def jax_value_grad(fn):
        mel, vjp = jax.vjp(lambda w: fn(w, jcfg), jnp.asarray(wav))
        return np.asarray(mel), np.asarray(vjp(jnp.cos(mel))[0])

    want, want_grad = jax_value_grad(wav2mel_gan)
    pallas, pallas_grad = jax_value_grad(lambda w, c: pallas_wav2mel_gan_diff(w, c,
                                                                             interpret=True))
    routes = {"plain": lambda w: port_wav2mel_gan(w, pcfg),
              "wrapper": lambda w: logmel_gan(w, pcfg),
              "function": lambda w: _LogmelGanFunction.apply(gan_pad(w, pcfg), pcfg,
                                                             LogmelGanKernel())}
    for name, fn in routes.items():
        got, got_grad = _sin_sum_grad(fn, wav)
        assert got.shape == want.shape == (2, 8000 // 160, 320), name
        for ref, ref_grad in ((want, want_grad), (pallas, pallas_grad)):
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL, err_msg=name)
            np.testing.assert_allclose(got_grad, ref_grad, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=name)


def test_logmel_gan_analytic_backward_matches_autograd():
    """The analytic backward against torch's autograd of the plain chain."""
    pcfg = PortMelConfig(**GAN_CFGS[1])
    wav = (np.random.default_rng(9).standard_normal((3, 4321)) * 0.3).astype(np.float32)
    want, want_grad = _sin_sum_grad(lambda w: port_wav2mel_gan(w, pcfg), wav)
    kernel = LogmelGanKernel()
    got, got_grad = _sin_sum_grad(
        lambda w: _LogmelGanFunction.apply(gan_pad(w, pcfg), pcfg, kernel), wav)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_grad, want_grad, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    assert kernel.launches == 0


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n_fft", [512, 1024])
@pytest.mark.parametrize("shape", [(3, 4321), (18, 8000)])
def test_logmel_gan_route_backward_matches_autograd_ragged(n_fft, shape):
    """The GAN route's backward (``_gan_vjp`` under the plain forward on the
    CPU) at the card test's seeds and geometry
    (tests/test_torch_cuda.py:test_logmel_gan_matches_plain_version_ragged):
    dwav against autograd of the plain version at GRAD_ATOL / GRAD_RTOL, and
    both against autograd of the plain version in float64, where the route
    lies within 1.5x the plain version's relative L2. The backward
    recomputes the DFT centred, as the forward does; an uncentred recompute
    put 10-15 elements past the bound in 3 of these 4 cases on one
    intra-op thread (the same 3 that failed on the card)."""
    pcfg = PortMelConfig(n_fft=n_fft, hop=160, win_length=n_fft, n_mels=320, fmin=0.0,
                         fmax=8000.0)
    wav = (np.random.default_rng(n_fft + shape[0]).standard_normal(shape) * 0.3
           ).astype(np.float32)
    kernel = LogmelGanKernel()
    route, route_grad = _sin_sum_grad(
        lambda w: _LogmelGanFunction.apply(gan_pad(w, pcfg), pcfg, kernel), wav)
    plain, plain_grad = _sin_sum_grad(lambda w: logmel_gan_reference(w, pcfg), wav)
    _, exact_grad = _sin_sum_grad(lambda w: logmel_gan_reference(w, pcfg),
                                  wav.astype(np.float64))
    assert kernel.launches == 0
    np.testing.assert_array_equal(route, plain)
    np.testing.assert_allclose(route_grad, plain_grad, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    route_err, plain_err = _rel_l2(route_grad, exact_grad), _rel_l2(plain_grad, exact_grad)
    assert route_err <= 1.5 * plain_err, (route_err, plain_err)


# K1's tables (csrc/logmel.cu): built on the CPU by the wrapper, uploaded once
# per device; the filterbank's resolutions of the GAN loss and of serving
MEL_CFGS = [(512, 320, 0.0, 8000.0), (1024, 320, 0.0, 8000.0), (2048, 320, 0.0, 8000.0),
            (1024, 80, 80.0, 7600.0)]


@pytest.mark.parametrize("n_fft,n_mels,fmin,fmax", MEL_CFGS)
def test_mel_bands_rebuild_the_filterbank(n_fft, n_mels, fmin, fmax):
    """The band tables give back the dense filterbank bit for bit, with the
    empty bands (53 of 320 at n_fft 512) as count 0."""
    melw = port_stft.mel_filterbank_np(16000, n_fft, n_mels, fmin, fmax).T
    first, count, offset, weights = _mel_bands_np(melw)
    dense = np.zeros_like(melw)
    for m in range(n_mels):
        dense[first[m]:first[m] + count[m], m] = weights[offset[m]:offset[m] + count[m]]
    np.testing.assert_array_equal(dense, melw)
    assert weights.dtype == np.float32 and offset[-1] + count[-1] == weights.size
    assert int((count == 0).sum()) == (53 if n_fft == 512 else 0)


@pytest.mark.parametrize("n_fft,win_length", [(512, 512), (1024, 1024), (2048, 2048),
                                              (1024, 800)])
def test_window_is_the_dft_basis_window(n_fft, win_length):
    """K1's window is the window inside the plain version's DFT basis (its
    cos(0) column), and the one the wrapper uploads."""
    window = port_stft._window_np(n_fft, win_length).astype(np.float32)
    np.testing.assert_array_equal(window, port_stft._dft_kernel_np(n_fft, win_length)[:, 0])
    cfg = PortMelConfig(n_fft=n_fft, win_length=win_length)
    np.testing.assert_array_equal(LogmelKernel().tables(cfg, torch.device("cpu"))[0].numpy(),
                                  window)


@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_twiddles_are_exp_rounded_to_fp32(n_fft):
    want = np.exp(-2j * np.pi * np.arange(n_fft // 2) / n_fft)
    tw = _twiddles_np(n_fft)
    assert tw.dtype == np.float32 and tw.shape == (n_fft // 2, 2)
    np.testing.assert_array_equal(tw[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], want.imag.astype(np.float32))


def test_tables_refuse_an_n_fft_the_fft_does_not_take():
    for n_fft in (1000, 1536, 16384):
        with pytest.raises(ValueError, match="power of two"):
            LogmelKernel().tables(PortMelConfig(n_fft=n_fft, win_length=min(n_fft, 1024)),
                                  torch.device("cpu"))


def _kernel_pipeline_np(frames, cfg, eps, clip, out_scale):
    """K1's arithmetic, in float64 numpy, from the wrapper's tables: window,
    the radix-2 Stockham passes as csrc/logmel.cu indexes them, magnitude,
    the banded mel sums, log."""
    window, tw, first, count, offset, weights = (
        t.numpy() for t in LogmelKernel().tables(cfg, torch.device("cpu")))
    n, half = cfg.n_fft, cfg.n_fft // 2
    x = frames * window.astype(np.float64)
    y = np.empty_like(x, dtype=np.complex128)
    x = x.astype(np.complex128)
    w = tw[:, 0].astype(np.float64) + 1j * tw[:, 1]
    t = np.arange(half)
    m = 1
    while m < n:
        k = t & (m - 1)
        c0, c1 = x[..., t], x[..., t + half]
        y[..., 2 * t - k] = c0 + c1
        y[..., 2 * t - k + m] = (c0 - c1) * w[t - k]
        x, y = y, x
        m <<= 1
    mag = np.sqrt(x.real[..., :half + 1] ** 2 + x.imag[..., :half + 1] ** 2 + eps)
    mel = np.stack([mag[..., f:f + c] @ weights[o:o + c].astype(np.float64)
                    for f, c, o in zip(first, count, offset)], axis=-1)
    return np.log(np.maximum(mel, clip)) * out_scale


@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_kernel_arithmetic_matches_plain_version(n_fft):
    """The kernel's algorithm from its own tables, emulated on the CPU,
    against both plain forms: serving (80 mels, log10) and GAN (320 mels,
    ln); the bound the card holds the kernel to."""
    wav = (np.random.default_rng(n_fft).standard_normal((2, 6400)) * 0.2).astype(np.float32)
    serve = PortMelConfig(n_fft=n_fft, win_length=n_fft)
    padded = np.pad(wav, ((0, 0), (n_fft // 2, n_fft // 2)))
    frames = np.lib.stride_tricks.sliding_window_view(padded, n_fft, axis=-1)[:, ::HOP]
    got = _kernel_pipeline_np(frames, serve, 0.0, 1e-6, 1 / np.log(10))
    np.testing.assert_allclose(got, logmel_reference(torch.from_numpy(wav), serve).numpy(),
                               atol=ATOL, rtol=RTOL)
    gan = PortMelConfig(**GAN_CFGS[[512, 1024, 2048].index(n_fft)])
    padded = gan_pad(torch.from_numpy(wav), gan).numpy()
    frames = np.lib.stride_tricks.sliding_window_view(padded, n_fft, axis=-1)[:, ::gan.hop]
    got = _kernel_pipeline_np(frames, gan, 1e-9, 1e-5, 1.0)
    np.testing.assert_allclose(got, port_wav2mel_gan(torch.from_numpy(wav), gan).numpy(),
                               atol=ATOL, rtol=RTOL)
