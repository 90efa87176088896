"""Tests of the PyTorch port that need the CUDA card. They import neither jax
nor conan_tpu, so they also run where only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a card each test skips (decided inside the test).
"""

import numpy as np
import pytest
import torch

from conan_tpu_torch.audio.mel import MelConfig
from conan_tpu_torch.infer.build import build_engine, write_random_checkpoints
from conan_tpu_torch.ops.groupconv import GroupConvKernel, grouped_conv1d_reference
from conan_tpu_torch.ops.logmel import LogmelGanKernel, LogmelKernel, logmel_gan_reference
from conan_tpu_torch.ops.logmel import logmel_reference

# K1 against its plain version: both fp32 over the same window and
# filterbank, the DFT computed another way (an FFT against a dense product);
# the bound tests/test_pallas_stft.py holds the Pallas kernel to
ATOL, RTOL = 2e-4, 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check_logmel(cfg, shape, seed):
    dev = _card()
    kernel = LogmelKernel()
    wav = torch.from_numpy((np.random.default_rng(seed).standard_normal(shape) * 0.2)
                           .astype(np.float32)).to(dev)
    got = kernel(wav, cfg)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, logmel_reference(wav, cfg), atol=ATOL, rtol=RTOL)
    assert kernel.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 81920), (1, 40960), (8, 48123), (3, 100), (2, 64 * 320)])
def test_kernel_matches_plain_version(shape):
    _check_logmel(MelConfig(), shape, seed=sum(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [512, 2048])
@pytest.mark.parametrize("shape", [(1, 81920), (3, 48123)])
def test_kernel_matches_plain_version_at_other_n_fft(n_fft, shape):
    """The serving form at the GAN loss's other FFT sizes: 5.12 s at B=1, and
    B=3 with a T that is no multiple of the hop."""
    _check_logmel(MelConfig(n_fft=n_fft, win_length=n_fft), shape, seed=n_fft)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    dev = _card()
    kernel = LogmelKernel()
    with pytest.raises(TypeError):
        kernel(torch.zeros(1, 8000, dtype=torch.float64, device=dev), MelConfig())
    with pytest.raises(ValueError):
        kernel(torch.zeros(8000, 2, device=dev).t(), MelConfig())
    for n_fft in (1000, 1536):    # the FFT takes powers of two only
        with pytest.raises(ValueError, match="power of two"):
            kernel(torch.zeros(1, 8000, device=dev), MelConfig(n_fft=n_fft, win_length=n_fft))
    assert kernel.launches == 0


# K2 against its plain version (cuDNN with TF32 off), the bounds
# tests/test_pallas_groupconv.py holds the Pallas kernel to: values atol 2e-4,
# rtol 1e-4; gradients (the same torch backward on both sides, from the
# kernel's and cuDNN's outputs) atol 5e-4, rtol 1e-3
MSD_LAYERS = [(128, 128, 2, 4), (128, 256, 2, 16), (256, 512, 4, 16), (512, 1024, 4, 16),
              (1024, 1024, 1, 16)]   # (ci, co, stride, groups), k 41, padding 20


def _check_groupconv(ci, co, s, g, B, T, seed):
    dev = _card()
    kernel = GroupConvKernel()
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, T, ci)).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((co, ci // g, 41)) / np.sqrt(41 * ci / g))
                         .astype(np.float32)).to(dev)
    outs = {}
    for name, fn in (("kernel", kernel), ("plain", grouped_conv1d_reference)):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xx, ww, stride=s, padding=(20, 20), groups=g)
        torch.sin(y).sum().backward()
        outs[name] = (y.detach(), xx.grad, ww.grad)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    (y, dx, dw), (y_ref, dx_ref, dw_ref) = outs["kernel"], outs["plain"]
    assert y.shape == y_ref.shape == (B, (T - 1) // s + 1, co)
    torch.testing.assert_close(y, y_ref, atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(dx, dx_ref, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(dw, dw_ref, atol=5e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("ci,co,s,g", MSD_LAYERS)
def test_groupconv_matches_plain_version(ci, co, s, g):
    """T_out 500, 250, 300 or 75: no multiple of the time tile."""
    _check_groupconv(ci, co, s, g, B=3, T=1000 if ci <= 256 else 300, seed=ci + co)


@pytest.mark.cuda
@pytest.mark.parametrize("ci,co,s,g", MSD_LAYERS)
def test_groupconv_matches_plain_version_at_scale_3_length(ci, co, s, g):
    """An output of 30 times, about the length of the MSD's scale 3 deep
    layers: one time tile, mostly masked."""
    _check_groupconv(ci, co, s, g, B=2, T=30 * s, seed=ci + co + 1)


@pytest.mark.cuda
def test_groupconv_rejects_what_it_does_not_take():
    dev = _card()
    kernel = GroupConvKernel()
    x, w = torch.zeros(1, 100, 128, device=dev), torch.zeros(128, 32, 41, device=dev)
    with pytest.raises(TypeError):
        kernel(x.double(), w.double(), groups=4)
    with pytest.raises(ValueError):
        kernel(torch.zeros(1, 128, 100, device=dev).transpose(1, 2), w, groups=4)
    with pytest.raises(ValueError):
        kernel(x, w, groups=3)
    with pytest.raises(ValueError):
        kernel(x, w.cpu(), groups=4)
    assert kernel.launches == 0


def _check_logmel_gan(n_fft, shape, seed):
    """K1's GAN form with its analytic backward against autograd of the plain
    chain: values atol 2e-4 / rtol 1e-4 as K1's serving form, dwav atol
    5e-4 / rtol 1e-3."""
    dev = _card()
    kernel = LogmelGanKernel()
    cfg = MelConfig(n_fft=n_fft, hop=160, win_length=n_fft, n_mels=320, fmin=0.0, fmax=8000.0)
    wav = torch.from_numpy((np.random.default_rng(seed).standard_normal(shape) * 0.3)
                           .astype(np.float32)).to(dev)
    outs = {}
    for name, fn in (("kernel", kernel), ("plain", logmel_gan_reference)):
        w = wav.clone().requires_grad_(True)
        mel = fn(w, cfg)
        torch.sin(mel).sum().backward()
        outs[name] = (mel.detach(), w.grad)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    assert outs["kernel"][0].shape == (shape[0], shape[1] // 160, 320)
    torch.testing.assert_close(outs["kernel"][0], outs["plain"][0], atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(outs["kernel"][1], outs["plain"][1], atol=5e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_logmel_gan_matches_plain_version(n_fft):
    _check_logmel_gan(n_fft, (4, 8000), seed=n_fft)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
@pytest.mark.parametrize("shape", [(3, 4321), (18, 8000)])
def test_logmel_gan_matches_plain_version_ragged(n_fft, shape):
    """B=3 on 4321 samples, no multiple of the hop, and the train step's
    B=18 x 8000."""
    _check_logmel_gan(n_fft, shape, seed=n_fft + shape[0])


# a small engine: 2-layer Emformer, hidden-64 Conan, 32-channel vocoder
_MEL = dict(audio_sample_rate=16000, fft_size=1024, hop_size=320, win_size=1024,
            fmin=80, fmax=7600, audio_num_mel_bins=80)
SMALL = {
    "conan": dict(_MEL, hidden_size=64, kernel_size=3, silent_token=57, style=True, nVQ=512,
                  f0_gen="orig", predictor_kernel=5, dec_dilations=[1, 1, 1, 1],
                  dec_kernel_size=5, layers_in_block=2),
    "emformer": dict(emformer_layers=2, chunk_size=80, right_context=2),
    "vocoder": dict(upsample_initial_channel=32, upsample_rates=[8, 5, 4, 2],
                    upsample_kernel_sizes=[16, 10, 8, 4], resblock_kernel_sizes=[3, 7, 11],
                    resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]]),
}


def _small_engine(tmp_path, serving_precision="exact"):
    """The small engine with seeded random weights, through build_engine."""
    dirs = write_random_checkpoints(str(tmp_path / "ckpt"), SMALL, seed=0)
    return build_engine(*dirs, serving_precision=serving_precision)


def _audio():
    rng = np.random.default_rng(0)
    return ((rng.standard_normal(320 * 24) * 0.1).astype(np.float32),
            (rng.standard_normal(320 * 40) * 0.1).astype(np.float32))


@pytest.mark.cuda
def test_small_engine_streams_as_offline_on_card(tmp_path):
    _card()
    eng = _small_engine(tmp_path)
    assert eng.device.type == "cuda"
    src, ref = _audio()
    wav, codes = eng.infer_once(src, ref, collect_codes=True)
    wav_off, codes_off = eng.infer_offline(src, ref, collect_codes=True)
    np.testing.assert_array_equal(codes, codes_off)
    np.testing.assert_allclose(wav, wav_off, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["high", "fast"])
def test_small_engine_rungs_on_card(tmp_path, rung):
    """TF32 and bf16 run the acoustic model and vocoder only: the Emformer
    stays fp32, so the codes equal exact's; the waveform is finite fp32."""
    _card()
    src, ref = _audio()
    _, codes_exact = _small_engine(tmp_path).infer_once(src, ref, collect_codes=True)
    wav, codes = _small_engine(tmp_path, rung).infer_once(src, ref, collect_codes=True)
    np.testing.assert_array_equal(codes, codes_exact)
    assert wav.dtype == np.float32 and np.isfinite(wav).all()
