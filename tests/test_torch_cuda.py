"""Tests of the PyTorch port that need the CUDA card. They import neither jax
nor conan_tpu, so they also run where only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a card each test skips (decided inside the test).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(18, 8000), (2, 10240)])
def test_logmel_gan_at_the_spec_disc_geometry(shape):
    """K1-GAN at the spectrogram discriminator's geometry (80 mels over
    80-7600 Hz at n_fft 1024, hop 320: the vocoder config's own mel) against
    its plain version, in value and in dwav: the train step's B=18 x 8000
    and B=2 x 10240, where every window of 8-32 frames fits."""
    dev = _card()
    kernel = LogmelGanKernel()
    cfg = MelConfig()
    wav = torch.from_numpy((np.random.default_rng(shape[1]).standard_normal(shape) * 0.3)
                           .astype(np.float32)).to(dev)
    outs = {}
    for name, fn in (("kernel", kernel), ("plain", logmel_gan_reference)):
        w = wav.clone().requires_grad_(True)
        mel = fn(w, cfg)
        torch.sin(mel).sum().backward()
        outs[name] = (mel.detach(), w.grad)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    assert outs["kernel"][0].shape == (shape[0], shape[1] // 320, 80)
    torch.testing.assert_close(outs["kernel"][0], outs["plain"][0], atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(outs["kernel"][1], outs["plain"][1], atol=5e-4, rtol=1e-3)


@pytest.mark.cuda
def test_conditional_msd_runs_k2_and_matches_the_plain_conv(monkeypatch):
    """The conditional MSD (its mel upsampled to each scale's rate as a
    second input channel): its 15 grouped layers launch K2, and its logits,
    feature maps and parameter gradients equal those of the same MSD with
    the plain grouped conv in K2's place: values at the bound of K2's own
    tests (atol 2e-4 / rtol 1e-4), the gradients as one tree within 1e-3
    (relative L2). Leaf by leaf they do not hold K2's dx/dw bound: through
    seven layers of leaky ReLU, a pre-activation within fp32 rounding of 0
    takes the other slope on the other route, which moved one bias element
    by 4.4e-3 (2.9e-3 of it) and the mel upsampler's weight by 1.9e-3 of
    its norm."""
    from conan_tpu_torch.checkpoint import tree_leaves, tree_map
    from conan_tpu_torch.models.vocoder.discriminators import MultiScaleDiscriminator
    from conan_tpu_torch.ops import conv as conv_ops

    dev = _card()
    msd = MultiScaleDiscriminator(use_cond=True)
    params = tree_map(lambda t: t.to(dev), msd.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    y = torch.from_numpy((0.3 * rng.standard_normal((2, 8000, 1))).astype(np.float32)).to(dev)
    mel = torch.from_numpy(rng.standard_normal((2, 25, 80)).astype(np.float32)).to(dev)

    def run():
        p = tree_map(lambda t: t.clone().requires_grad_(True), params)
        outs, fmaps = msd.forward(p, y, mel)
        loss = sum(torch.sin(o).sum() for o in outs)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        return [o.detach() for o in outs] + [f.detach() for fm in fmaps for f in fm], grads

    kernel = GroupConvKernel()
    monkeypatch.setattr(conv_ops, "groupconv", kernel)
    got, got_g = run()
    assert kernel.launches == 15
    monkeypatch.setattr(conv_ops, "groupconv", grouped_conv1d_reference)
    want, want_g = run()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-4)
    flat = [torch.cat([g.ravel() for g in gs]) for gs in (got_g, want_g)]
    assert float((flat[0] - flat[1]).norm() / flat[1].norm()) < 1e-3


@pytest.mark.cuda
def test_msd_input_gradient_on_card_matches_cpu_in_float64():
    """The gradient the conditional MSD sends back to its input wav (the
    generator's share of the adversarial loss), each scale on its own, in
    float64 with the plain grouped conv and cuDNN off: on the card as on the
    CPU to 1e-12. F.avg_pool1d on the [B, 1, T] view, which the pooled
    scales used before, gave 69-76% off here while its forward agreed."""
    from conan_tpu_torch.checkpoint import tree_map
    from conan_tpu_torch.models.vocoder.discriminators import MultiScaleDiscriminator
    from conan_tpu_torch.ops import conv as conv_ops

    dev = _card()
    msd = MultiScaleDiscriminator(use_cond=True)
    params = tree_map(lambda t: t.double(), msd.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(2)
    y = torch.from_numpy(0.3 * rng.standard_normal((2, 8000, 1)))
    mel = torch.from_numpy(rng.standard_normal((2, 25, 80)))

    def input_grads(device):
        x = y.to(device).requires_grad_(True)
        outs, _ = msd.forward(tree_map(lambda t: t.to(device), params), x, mel.to(device))
        return [torch.autograd.grad(torch.mean((1 - o) ** 2), x, retain_graph=True)[0].cpu()
                for o in outs]

    saved = conv_ops.groupconv
    conv_ops.groupconv = grouped_conv1d_reference
    try:
        with torch.backends.cudnn.flags(enabled=False):
            got, want = input_grads(dev), input_grads("cpu")
    finally:
        conv_ops.groupconv = saved
    for scale, (a, b) in enumerate(zip(got, want)):
        assert float((a - b).norm() / b.norm()) < 1e-12, scale


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


# the captured chunk loop (stream_scan on the card) against the eager loop
SMALL_FLOW = dict(SMALL, conan=dict(SMALL["conan"], f0_gen="flow", f0_K_step=6,
                                    f0_residual_layers=2, f0_residual_channels=16))


def _engine(tmp_path, f0_gen="orig", serving_precision="exact"):
    """The small engine; for f0_gen="flow" the denoiser's zero-init output
    head gets seeded random weights, so that the flow moves the F0."""
    hp = SMALL_FLOW if f0_gen == "flow" else SMALL
    dirs = write_random_checkpoints(str(tmp_path / f"ckpt_{f0_gen}"), hp, seed=0)
    eng = build_engine(*dirs, serving_precision=serving_precision)
    if f0_gen == "flow":
        head = eng.p_conan["f0_net"]["out_proj"]
        head["w"] = 0.3 * torch.randn(head["w"].shape, generator=torch.Generator().manual_seed(1)
                                      ).to(head["w"].device)
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["exact", "high", "fast"])
@pytest.mark.parametrize("f0_gen", ["orig", "flow"])
def test_captured_loop_equals_eager_on_card(tmp_path, f0_gen, rung):
    """One capture per shape; the replayed chunks give the eager loop's
    codes, and in exact its waveform to 1e-5 (the same kernels on the same
    inputs). In high and fast the codes only: the captured cuBLAS calls may
    take other algorithms than the eager ones."""
    _card()
    eng = _engine(tmp_path, f0_gen, rung)
    src, ref = _audio()
    wav, codes = eng.infer_once(src, ref, collect_codes=True)
    got, got_codes = eng.infer_once(src, ref, collect_codes=True, use_scan=True)
    assert len(eng._captured) == 1
    np.testing.assert_array_equal(got_codes, codes)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    if rung == "exact":
        np.testing.assert_allclose(got, wav, atol=1e-5)
        np.testing.assert_allclose(got, eng.infer_offline(src, ref), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("f0_gen", ["orig", "flow"])
def test_captured_loop_resets_state_between_utterances(tmp_path, f0_gen):
    """A second utterance of the same shape replays the same graph from
    init_state: it equals a fresh engine's output, not a continuation."""
    _card()
    eng = _engine(tmp_path, f0_gen)
    src, ref = _audio()
    other = src[::-1].copy()
    first = eng.infer_once(src, ref, use_scan=True)
    second = eng.infer_once(other, ref, use_scan=True)
    assert len(eng._captured) == 1
    fresh = _engine(tmp_path, f0_gen)
    np.testing.assert_array_equal(second, fresh.infer_once(other, ref, use_scan=True))
    np.testing.assert_array_equal(first, eng.infer_once(src, ref, use_scan=True))


@pytest.mark.cuda
def test_failed_capture_raises_without_eager_fallback(tmp_path, monkeypatch):
    """A step that copies from the host fails the capture: stream_scan
    raises, caches nothing and returns no eager result; the engine then
    captures the real step as before."""
    _card()
    eng = _engine(tmp_path)
    src, ref = _audio()
    step = eng._chunk_step

    def step_with_host_copy(*args):
        wav, codes, state = step(*args)
        return wav + torch.tensor([0.0], device=wav.device), codes, state

    monkeypatch.setattr(eng, "_chunk_step", step_with_host_copy)
    with pytest.raises(RuntimeError):
        eng.infer_once(src, ref, use_scan=True)
    assert not eng._captured
    monkeypatch.setattr(eng, "_chunk_step", step)
    wav = eng.infer_once(src, ref)
    np.testing.assert_allclose(eng.infer_once(src, ref, use_scan=True), wav, atol=1e-5)


# The Conan training step at small width (tests/test_train_steps.py's CONAN_HP
# sizes over egs/soak_r5/conan.yaml), at a step where every gate is on. The
# card's step against the CPU's (oneDNN off) from one state and batch, no
# generator on either side (dropout off, crops at frame 0): loss terms rtol
# 1e-4 from the CPU's fp32 step; each gradient leaf (the optimizers' first
# moments) and VQ-state leaf a relative L2 error from the CPU's float64 step
# within max(1e-3, 4 x the CPU fp32 step's worst), chip_smoke.py's rule.
CONAN_SMALL = {"hidden_size": 32, "nVQ": 16, "mel_disc_hidden_size": 8, "vq_start": 1,
               "forcing": 2, "disc_start_steps": 3, "random_speaker_steps": 5,
               "train_precision": "highest"}


def _conan_task(device, rung="highest"):
    import os

    from conan_tpu_torch.config import load_config
    from conan_tpu_torch.train.tasks import ConanTask

    hp = load_config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "egs", "soak_r5", "conan.yaml"))
    hp.update(CONAN_SMALL, train_precision=rung)
    return ConanTask(hp, device=device)


def _conan_batch(B=2, T=160, Tr=128):
    rng = np.random.default_rng(1)
    batch = {"content": rng.integers(0, 100, (B, T)),
             "mels": (rng.standard_normal((B, T, 80)) * 0.5 - 4).astype(np.float32),
             "ref_mels": (rng.standard_normal((B, Tr, 80)) * 0.5 - 4).astype(np.float32),
             "f0": (rng.standard_normal((B, T)) * 0.3 + 7.5).astype(np.float32),
             "uv": (rng.random((B, T)) < 0.2).astype(np.float32)}
    batch["content"][1, T - 20:] = -1
    for k in ("mels", "f0", "uv"):
        batch[k][1, T - 20:] = 0
    return batch


@pytest.mark.cuda
def test_conan_step_on_card_matches_cpu():
    from conan_tpu_torch.checkpoint import tree_leaves, tree_map

    dev = _card()
    task, task_cpu = _conan_task(None), _conan_task("cpu")
    batch = _conan_batch()
    state, done = task.host_hook(task.init_state(torch.Generator().manual_seed(0)), 4, batch)
    assert done
    state["step"] = torch.tensor(4, dtype=torch.int32, device=dev)
    new_gpu, m_gpu = task.train_step(state, batch, None, use_random_ref=True)
    with torch.backends.mkldnn.flags(enabled=False):
        new_cpu, m_cpu = task_cpu.train_step(tree_map(lambda t: t.cpu(), state), batch, None,
                                             use_random_ref=True)
        new_64, _ = task_cpu.train_step(
            tree_map(lambda t: t.cpu().double() if t.is_floating_point() else t.cpu(), state),
            {k: v.astype(np.float64) if v.dtype.kind == "f" else v for k, v in batch.items()},
            None, use_random_ref=True)
    for k in m_cpu:
        assert float(m_gpu[k]) == pytest.approx(float(m_cpu[k]), rel=1e-4, abs=0), k
    assert all(float(m_cpu[k]) != 0 for k in ("vq_loss", "gloss", "a", "d_r"))

    def leaves(st):
        return (tree_leaves(st["opt_g"]["mu"]) + tree_leaves(st["opt_d"]["mu"])
                + [st["vq_state"][k] for k in ("embedding", "ema_count", "ema_weight")])

    def errs(st):
        return [float((a.cpu().double() - b).norm() / b.norm().clamp(min=1e-30))
                for a, b in zip(leaves(st), leaves(new_64))]

    limit = max(1e-3, 4 * max(errs(new_cpu)))
    assert max(errs(new_gpu)) <= limit


@pytest.mark.cuda
def test_conan_kmeans_hook_defers_on_too_few_frames():
    """Fewer nonzero prosody rows than codewords: the hook defers (no
    k-means, no error) and the codebook stays uninitialized."""
    _card()
    task = _conan_task(None)
    state = task.init_state(torch.Generator().manual_seed(0))
    tiny = {k: v[:1, :32] for k, v in _conan_batch().items()}      # 8 rows < 16
    assert task.host_hook(state, 2, tiny) == (None, False)
    assert float(state["vq_state"]["initialized"]) == 0.0
    new, done = task.host_hook(state, 3, _conan_batch())
    assert done and float(new["vq_state"]["initialized"]) == 1.0
    assert new["vq_state"]["embedding"].device.type == "cuda"


@pytest.mark.cuda
def test_conan_step_draws_on_card():
    """The training step's own draws from a CUDA generator, as
    tests/test_torch_conan_train.py checks them on the CPU: dropout keeps
    1 - rate and scales by 1 / (1 - rate); the mel discriminator's crop
    starts cover [0, max(len) - w] and Dropout2d drops whole channels at 0.25."""
    from conan_tpu_torch.checkpoint import tree_map
    from conan_tpu_torch.models.vocoder.discriminators import MultiWindowDiscriminator
    from conan_tpu_torch.nn.blocks import dropout

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.ones(200_000, device=dev)
    y = dropout(x, 0.25, gen)
    assert abs(float((y == 0).float().mean()) - 0.25) < 0.005
    assert bool(torch.all((y == 0) | (y == 1 / 0.75)))
    d = MultiWindowDiscriminator((8, 16), 12, 8)
    p = tree_map(lambda t: t.to(dev), d.init(torch.Generator().manual_seed(1)))
    mel = torch.randn(4, 40, 12, generator=torch.Generator().manual_seed(3)).to(dev) + 3.0
    mel[:, 30:] = 0.0                                  # max(len) 30 of T 40
    starts, dropped = [[], []], []
    for _ in range(300):
        _, hs, used, fit = d.apply(p, mel, gen)
        assert bool(fit)
        for i, s in enumerate(used):
            starts[i].append(int(s))
        dropped.append((hs[2].abs().sum(dim=(2, 3)) == 0).float().mean())
    for s, w in zip(starts, (8, 16)):
        assert min(s) == 0 and max(s) == 30 - w
    assert abs(float(torch.stack(dropped).mean()) - 0.25) < 0.03


# The Emformer distillation step at small width (tests/test_torch_emformer_train.py's
# sizes: 2 layers, input 16, 2 heads, FFN 32, segment 4, left context 8, rc 2,
# 10 codes), B = 2 of 40 segments: the card's step against the CPU's from one
# state and batch, with chip_smoke.py's rule (ce and acc rtol 1e-4 from the
# CPU's fp32 step; each gradient leaf, the first moments, within max(1e-3,
# 4 x the CPU fp32 step's worst) of the CPU's float64 step).
EMF_SMALL = dict(input_dim=16, num_heads=2, ffn_dim=32, num_layers=2, segment_length=4,
                 left_context_length=8, right_context_length=2, output_dim=10)
EMF_HP = {"emformer_input_dim": 16, "emformer_layers": 2, "chunk_size": 80,
          "right_context": 2, "emformer_output_dim": 10, "lr": 1e-3, "warmup_steps": 2,
          "train_precision": "highest"}


def _emformer_task(device, rung="highest"):
    from conan_tpu_torch.models.emformer import EmformerConfig, EmformerDistillModel
    from conan_tpu_torch.train.tasks import EmformerTask

    task = EmformerTask(dict(EMF_HP, train_precision=rung), device=device)
    task.model = EmformerDistillModel(EmformerConfig(**EMF_SMALL))
    return task


def _numpy_mask(n_segs: int, seg: int, rc: int, L: int) -> np.ndarray:
    """The offline attention mask written out in numpy: rows and columns
    [rc blocks ∥ utterance]; a query of segment s sees rc block s and the
    utterance frames [s·seg - L, (s+1)·seg)."""
    T, nrc = n_segs * seg, n_segs * rc
    q_seg = np.concatenate([np.arange(nrc) // max(rc, 1), np.arange(T) // seg])
    mask = np.full((nrc + T, nrc + T), -1e8, np.float32)
    for q, s in enumerate(q_seg):
        mask[q, s * rc:(s + 1) * rc] = 0.0
        mask[q, nrc + max(s * seg - L, 0):nrc + (s + 1) * seg] = 0.0
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [(4, 2, 50), (4, 0, 8), (3, 1, 5)])
def test_emformer_mask_on_card_matches_numpy(geometry):
    from conan_tpu_torch.models.emformer import EmformerConfig, Emformer

    dev = _card()
    seg, rc, L = geometry
    emf = Emformer(EmformerConfig(segment_length=seg, right_context_length=rc,
                                  left_context_length=L))
    for n_segs in (1, 7, 132):
        got = emf.offline_mask(n_segs, dev)
        assert got.device.type == "cuda" and got.dtype == torch.float32
        np.testing.assert_array_equal(got.cpu().numpy(), _numpy_mask(n_segs, seg, rc, L))
        assert emf.offline_mask(n_segs, dev) is got


@pytest.mark.cuda
def test_emformer_step_on_card_matches_cpu():
    from conan_tpu_torch.checkpoint import tree_leaves, tree_map

    dev = _card()
    task, task_cpu = _emformer_task(None), _emformer_task("cpu")
    rng = np.random.default_rng(2)
    T = 40 * 4
    batch = {"mels": rng.standard_normal((2, T + 2, 16)).astype(np.float32),
             "content": rng.integers(0, 10, (2, T))}
    batch["content"][0, T - 2:] = -1
    batch["content"][1, T - 30:] = -1
    state = task.init_state(torch.Generator().manual_seed(0))
    new_gpu, m_gpu = task.train_step(state, batch)
    new_cpu, m_cpu = task_cpu.train_step(tree_map(lambda t: t.cpu(), state), batch)
    new_64, _ = task_cpu.train_step(
        tree_map(lambda t: t.cpu().double() if t.is_floating_point() else t.cpu(), state),
        dict(batch, mels=batch["mels"].astype(np.float64)))
    for k in ("ce", "acc"):
        assert float(m_gpu[k]) == pytest.approx(float(m_cpu[k]), rel=1e-4, abs=0), k
    assert float(m_gpu["skipped"]) == float(m_cpu["skipped"]) == 0.0

    def errs(st):
        return [float((a.cpu().double() - b).norm() / b.norm().clamp(min=1e-30))
                for a, b in zip(tree_leaves(st["opt"]["mu"]), tree_leaves(new_64["opt"]["mu"]))]

    assert max(errs(new_gpu)) <= max(1e-3, 4 * max(errs(new_cpu)))


# K2-bf16, the "default" training rung's grouped conv, against its plain
# version (the fp32 grouped conv of the bf16-rounded operands) on the MSD's
# 15 grouped geometries of an 8000-sample batch: values as K2's; dx and dw
# (cuDNN from bf16 operands, a bf16 result) against the same convs in fp32
# on the rounded operands with the incoming gradient rounded, relative L2
# within chip_smoke.py's BF16_GRAD_REL (one bf16 rounding of each result)
def _msd_geometries():
    from chip_smoke import msd_grouped_geometries

    return msd_grouped_geometries(8000)


def _check_groupconv_bf16(B, T, ci, co, k, s, g, pd, seed):
    from chip_smoke import BF16_GRAD_REL, rel_l2
    from conan_tpu_torch.ops.groupconv import grouped_conv1d_bf16_reference
    from conan_tpu_torch.ops.precision import rounded_dot, training_scope

    dev = _card()
    kernel = GroupConvKernel()
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, T, ci)).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((co, ci // g, k)) / np.sqrt(k * ci / g))
                         .astype(np.float32)).to(dev)
    conv = dict(stride=s, padding=(pd, pd), groups=g)
    outs = {}
    for name, fn in (("kernel", lambda a, b: kernel(a, b, **conv)),
                     ("plain", lambda a, b: rounded_dot(
                         lambda aa, bb: grouped_conv1d_reference(aa, bb, **conv), a, b))):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        with training_scope("default", dev):
            y = fn(xx, ww)
            torch.sin(y).sum().backward()
        outs[name] = (y.detach(), xx.grad, ww.grad)
    torch.cuda.synchronize()
    assert kernel.launches_bf16 == 1 and kernel.launches == 0
    (y, dx, dw), (y_ref, dx_ref, dw_ref) = outs["kernel"], outs["plain"]
    torch.testing.assert_close(y_ref, grouped_conv1d_bf16_reference(x, w, **conv), rtol=0,
                               atol=0)
    torch.testing.assert_close(y, y_ref, atol=2e-4, rtol=1e-4)
    assert rel_l2(dx, dx_ref) <= BF16_GRAD_REL and rel_l2(dw, dw_ref) <= BF16_GRAD_REL


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(15))
def test_groupconv_bf16_matches_plain_version(index):
    _scale, T, ci, co, k, s, g, pd = _msd_geometries()[index]
    _check_groupconv_bf16(2, T, ci, co, k, s, g, pd, seed=index)


@pytest.mark.cuda
@pytest.mark.parametrize("index", [3, 4, 8, 9, 13, 14])
def test_groupconv_bf16_deep_layers_at_the_training_batch(index):
    """The six short deep layers (T_out 125, 63, 32) at B = 18, where M
    tiles hold several batch rows."""
    _scale, T, ci, co, k, s, g, pd = _msd_geometries()[index]
    _check_groupconv_bf16(18, T, ci, co, k, s, g, pd, seed=100 + index)


# (B, T, ci, co, k, stride, groups, pad): B = 1 and 3, T_out 121 and 249 (no
# tile's multiple), 13, 7 and 1 (under 16), the cig 8 layer
BF16_RAGGED = [(1, 8000, 128, 128, 41, 2, 4, 20), (3, 121, 1024, 1024, 41, 1, 16, 20),
               (5, 993, 256, 512, 41, 4, 16, 20), (7, 13, 1024, 1024, 41, 1, 16, 20),
               (3, 13, 128, 128, 41, 2, 4, 20), (2, 497, 128, 256, 41, 2, 16, 20),
               (1, 1, 512, 1024, 41, 4, 16, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_RAGGED)
def test_groupconv_bf16_ragged(case):
    _check_groupconv_bf16(*case, seed=sum(case))


@pytest.mark.cuda
def test_groupconv_bf16_build_failure_raises(monkeypatch, tmp_path):
    """No silent route: a K2 library that does not build raises under the
    "default" rung, and nothing falls back to cuDNN."""
    from conan_tpu_torch.ops import native
    from conan_tpu_torch.ops.precision import training_scope

    dev = _card()
    kernel = GroupConvKernel()
    x, w = torch.zeros(1, 100, 128, device=dev), torch.zeros(128, 32, 41, device=dev)
    native.load.cache_clear()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libconan_kernels.so")
    monkeypatch.setattr(native, "_nvcc", lambda: "/bin/false")
    try:
        with training_scope("default", dev), pytest.raises(RuntimeError, match="nvcc failed"):
            kernel(x, w, groups=4)
    finally:
        native.load.cache_clear()
    assert kernel.launches_bf16 == kernel.launches == 0


# K2-bf16 dx and dw, the "default" rung's backward, against their plain
# versions (conv1d_input / conv1d_weight in fp32 on the bf16-rounded
# operands): the same exact bf16 products summed in fp32 in another order,
# relative L2 within 1e-4 (chip_smoke.py's BF16_KERNEL_GRAD_REL)
def _check_groupconv_bf16_grads(B, T, ci, co, k, s, g, pd, seed):
    from chip_smoke import BF16_KERNEL_GRAD_REL, rel_l2
    from conan_tpu_torch.ops.groupconv import (grouped_conv1d_bf16_input_grad_reference,
                                               grouped_conv1d_bf16_weight_grad_reference)

    dev = _card()
    kernel = GroupConvKernel()
    rng = np.random.default_rng(seed)
    T_out = (T + 2 * pd - k) // s + 1
    x = torch.from_numpy(rng.standard_normal((B, T, ci)).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((co, ci // g, k)) / np.sqrt(k * ci / g))
                         .astype(np.float32)).to(dev)
    gy = torch.from_numpy(rng.standard_normal((B, T_out, co)).astype(np.float32)).to(dev)
    conv = dict(stride=s, padding=(pd, pd), groups=g)
    dx = kernel.input_grad_bf16(gy, w, x.shape, **conv)
    dw = kernel.weight_grad_bf16(x, gy, w.shape, **conv)
    dx2 = kernel.input_grad_bf16(gy, w, x.shape, **conv)
    dw2 = kernel.weight_grad_bf16(x, gy, w.shape, **conv)
    torch.cuda.synchronize()
    assert (kernel.launches_bf16_dx, kernel.launches_bf16_dw) == (2, 2)
    assert dx.shape == x.shape and dw.shape == w.shape
    assert dx.dtype == dw.dtype == torch.float32
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)          # the same bits
    want_dx = grouped_conv1d_bf16_input_grad_reference(gy, w, x.shape, **conv)
    want_dw = grouped_conv1d_bf16_weight_grad_reference(x, gy, w.shape, **conv)
    assert torch.isfinite(dx).all() and torch.isfinite(dw).all()
    assert rel_l2(dx, want_dx) <= BF16_KERNEL_GRAD_REL, rel_l2(dx, want_dx)
    assert rel_l2(dw, want_dw) <= BF16_KERNEL_GRAD_REL, rel_l2(dw, want_dw)


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(15))
def test_groupconv_bf16_grads_match_plain_versions(index):
    _scale, T, ci, co, k, s, g, pd = _msd_geometries()[index]
    _check_groupconv_bf16_grads(2, T, ci, co, k, s, g, pd, seed=200 + index)


@pytest.mark.cuda
@pytest.mark.parametrize("index", [3, 4, 8, 9, 13, 14])
def test_groupconv_bf16_grads_deep_layers_at_the_training_batch(index):
    _scale, T, ci, co, k, s, g, pd = _msd_geometries()[index]
    _check_groupconv_bf16_grads(18, T, ci, co, k, s, g, pd, seed=300 + index)


# the forward's ragged cases; pads no stride divides (dx's phases then start
# off a row of gy) with T_out 1; T_out 64 under dw's 2 and 4 shifts of gy
BF16_GRAD_RAGGED = BF16_RAGGED + [(2, 301, 128, 128, 41, 2, 4, 7), (3, 77, 256, 512, 41, 4, 16, 5),
                                  (2, 3, 512, 1024, 41, 4, 16, 19),
                                  (2, 128, 128, 128, 41, 2, 4, 20),
                                  (1, 128, 128, 256, 41, 2, 16, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_GRAD_RAGGED)
def test_groupconv_bf16_grads_ragged(case):
    _check_groupconv_bf16_grads(*case, seed=sum(case))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 8000, 128, 128, 41, 2, 4, 20),     # 4 tiles: splits
                                  (18, 500, 1024, 1024, 41, 1, 16, 20)])  # 80 tiles: none
def test_groupconv_bf16_dw_splits_in_one_launch_with_the_same_bits(case):
    """K2-bf16 dw is one launch a call: a plan that splits adds its splits
    in order inside it (the same bits on every call; its tile counters,
    kept per device, left zeroed), and a plan that does not split
    allocates neither workspace nor counters."""
    from chip_smoke import BF16_KERNEL_GRAD_REL, rel_l2
    from conan_tpu_torch.ops.groupconv import (bf16_wgrad_plan,
                                               grouped_conv1d_bf16_weight_grad_reference,
                                               sm_count)

    dev = _card()
    B, T, ci, co, k, s, g, pd = case
    kernel = GroupConvKernel()
    rng = np.random.default_rng(sum(case))
    T_out = (T + 2 * pd - k) // s + 1
    x = torch.from_numpy(rng.standard_normal((B, T, ci)).astype(np.float32)).to(dev)
    gy = torch.from_numpy(rng.standard_normal((B, T_out, co)).astype(np.float32)).to(dev)
    plan = bf16_wgrad_plan(B, T_out, ci, co, g, k, s, sm_count(x.device.index))
    conv = dict(stride=s, padding=(pd, pd), groups=g)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        dws = [kernel.weight_grad_bf16(x, gy, (co, ci // g, k), **conv) for _ in range(3)]
        torch.cuda.synchronize()
    launched = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and "k2bf16" in e.key]
    assert kernel.launches_bf16_dw == 3
    assert all(torch.equal(dws[0], d) for d in dws[1:])
    want = grouped_conv1d_bf16_weight_grad_reference(x, gy, (co, ci // g, k), **conv)
    assert rel_l2(dws[0], want) <= BF16_KERNEL_GRAD_REL
    assert sum(e.count for e in launched) <= 3 and all("wgrad_kernel" in e.key for e in launched)
    if plan.splits > 1:
        assert case[0] == 2 and not kernel._counters[x.device].any()
    else:
        assert case[0] == 18 and x.device not in kernel._counters


@pytest.mark.cuda
def test_groupconv_bf16_input_grad_alone_launches_no_weight_grad():
    """autograd.grad for dx alone where the weights take no gradient (the
    generator step's MSD pass) runs K2-bf16 dx and not dw; where they do
    (the discriminator step's), one of each. (A custom Function's backward
    learns which inputs require a gradient, not which ones a call asks for.)"""
    from conan_tpu_torch.ops.precision import training_scope

    dev = _card()
    kernel = GroupConvKernel()
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 500, 256, generator=gen).to(dev).requires_grad_(True)
    w = (0.05 * torch.randn(512, 16, 41, generator=gen)).to(dev)
    with training_scope("default", dev):
        y = kernel(x, w, stride=4, padding=(20, 20), groups=16)
        (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
        assert (kernel.launches_bf16_dx, kernel.launches_bf16_dw) == (1, 0)
        w.requires_grad_(True)
        y = kernel(x, w, stride=4, padding=(20, 20), groups=16)
        torch.autograd.grad(y, (x, w), torch.ones_like(y))
    assert (kernel.launches_bf16_dx, kernel.launches_bf16_dw) == (2, 1)
    assert kernel.launches_bf16 == 2 and kernel.launches == 0 and torch.isfinite(dx).all()


@pytest.mark.cuda
def test_groupconv_bf16_grad_build_failure_raises(monkeypatch, tmp_path):
    """No silent route for the backward either: a library that does not
    build raises from dx and from dw, and nothing falls back to cuDNN."""
    from conan_tpu_torch.ops import native

    dev = _card()
    kernel = GroupConvKernel()
    x, w = torch.zeros(1, 100, 128, device=dev), torch.zeros(128, 32, 41, device=dev)
    gy = torch.zeros(1, 100, 128, device=dev)
    conv = dict(stride=1, padding=(20, 20), groups=4)
    native.load.cache_clear()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libconan_kernels.so")
    monkeypatch.setattr(native, "_nvcc", lambda: "/bin/false")
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            kernel.input_grad_bf16(gy, w, x.shape, **conv)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            kernel.weight_grad_bf16(x, gy, w.shape, **conv)
    finally:
        native.load.cache_clear()
    assert kernel.launches_bf16_dx == kernel.launches_bf16_dw == 0


# Each task's step at the "default" (bf16 operands) and "high" (TF32) rungs
# on the card at small width, against the port's own float64 step on the CPU
# from the same state and batch: chip_smoke.py's rung_check and RUNG_BOUND
# (the losses' sum and the gradient leaves as one tree, relative)
def _rung_case(kind: str):
    """(make_task(rung, device), state on the card, batch, step kwargs,
    leaves_of) of one task at small width."""
    import os

    from conan_tpu_torch.checkpoint import tree_leaves, tree_map
    from conan_tpu_torch.config import load_config
    from conan_tpu_torch.models.conan.model import Conan, ConanConfig
    from conan_tpu_torch.train.tasks import ConanTask, PostnetTask, VocoderTask

    egs = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "egs",
                       "soak_r5")
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(0)
    both = lambda st: tree_leaves(st["opt_g"]["mu"]) + tree_leaves(st["opt_d"]["mu"])  # noqa
    mu = lambda st: tree_leaves(st["opt"]["mu"])  # noqa: E731
    if kind == "vocoder":
        hp = dict(load_config(os.path.join(egs, "vocoder.yaml")), upsample_initial_channel=32)
        make = lambda rung, d: VocoderTask(dict(hp, train_precision=rung), device=d)  # noqa
        batch = {"mels": (rng.standard_normal((2, 8, 80)) - 4).astype(np.float32),
                 "wavs": (rng.standard_normal((2, 8 * 320)) * 0.1).astype(np.float32)}
        return make, make("highest", None).init_state(gen), batch, {}, both
    if kind == "emformer":
        make = lambda rung, d: _emformer_task(d, rung)  # noqa: E731
        T = 40 * 4
        batch = {"mels": rng.standard_normal((2, T + 2, 16)).astype(np.float32),
                 "content": rng.integers(0, 10, (2, T))}
        batch["content"][1, T - 30:] = -1
        return make, make("highest", None).init_state(gen), batch, {}, mu
    batch = _conan_batch()
    if kind == "conan":
        make = lambda rung, d: _conan_task(d, rung)  # noqa: E731
        task = make("highest", None)
        state, _ = task.host_hook(task.init_state(gen), 4, batch)
        state["step"] = torch.tensor(4, dtype=torch.int32, device=_card())
        return make, state, batch, {"use_random_ref": True}, both
    hp = dict(load_config(os.path.join(egs, "postnet.yaml")), **CONAN_SMALL,
              residual_layers=2, residual_channels=16, spec_min=[-8.0] * 80,
              spec_max=[1.0] * 80)
    conan = Conan(ConanConfig.from_hparams(hp))
    frozen = tree_map(lambda t: t.numpy(), conan.init(gen))
    vq = tree_map(lambda t: t.numpy(), conan.init_vq_state(gen))

    def make(rung, d):
        task = PostnetTask(dict(hp, train_precision=rung), frozen, vq, device=d)
        draws = task.postnet.flow.draws
        task.postnet.flow.draws = lambda x1, g: tuple(
            t.to(x1.device) for t in draws(x1.cpu(), torch.Generator().manual_seed(5)))
        return task

    return make, make("highest", None).init_state(gen), batch, {}, mu


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["vocoder", "conan", "emformer", "postnet"])
def test_rung_steps_on_card_match_float64(kind):
    from chip_smoke import rung_check
    from conan_tpu_torch.checkpoint import tree_map

    _card()
    make, state, batch, kw, leaves_of = _rung_case(kind)
    with torch.backends.mkldnn.flags(enabled=False):
        new_64, m_64 = make("highest", "cpu").train_step(
            tree_map(lambda t: t.cpu().double() if t.is_floating_point() else t.cpu(), state),
            {k: v.astype(np.float64) if v.dtype.kind == "f" else v for k, v in batch.items()},
            None, **kw)
    text = rung_check(kind, lambda rung: make(rung, None), state, batch, m_64, leaves_of(new_64),
                      leaves_of, **kw)
    print(text)


@pytest.mark.cuda
def test_rmvpe_salience_on_card_matches_cpu():
    """RMVPE at the published geometry (seeded weights through the
    reference's state-dict names) on a 2 s clip: the card's salience (cuDNN
    convs and GRU, TF32 off) within 1e-4 of the CPU's, the same shape."""
    from conan_tpu_torch.models.rmvpe import E2E0, RMVPE

    dev = _card()
    model = E2E0()
    sd = model.params_to_torch(model.init(torch.Generator().manual_seed(0)))
    card = RMVPE(model.params_from_torch(sd), device=dev)
    cpu = RMVPE(model.params_from_torch(sd, device="cpu"), device="cpu")
    rng = np.random.default_rng(1)
    t = np.arange(32000) / 16000
    wav = (0.1 * np.sin(2 * np.pi * 180 * t) + 0.01 * rng.standard_normal(t.size))
    x = torch.from_numpy(wav.astype(np.float32)[None])
    got = card.salience(x.to(dev)).cpu()
    want = cpu.salience(x)
    assert got.shape == want.shape == (1, 201, 360)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# data parallelism (conan_tpu_torch/parallel) on the card
# ---------------------------------------------------------------------------
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


def _dist_worker():
    """tests/torch_dist_worker.py (the port only), imported by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_dist_worker", os.path.join(TESTS_DIR, "torch_dist_worker.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_nccl_group_of_one_rank_step_equals_no_group(tmp_path):
    """A vocoder step through an NCCL group of one rank (the gradient
    all-reduce, the metrics' reduce) equals the step with no group bit for
    bit, with cuDNN's deterministic algorithms."""
    from conan_tpu_torch.checkpoint import tree_leaves
    from conan_tpu_torch.parallel import dist
    from conan_tpu_torch.train.tasks import VocoderTask

    dev = _card()
    W = _dist_worker()
    batch = W.vocoder_batch(3, W.VOC_PLAIN_FRAMES)
    world = dist.init_distributed(dev, backend="nccl", init_method=f"file://{tmp_path}/rdv",
                                  rank=0, world_size=1)
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
            task = VocoderTask(W.VOC_PLAIN, device=dev)
            state0 = task.init_state(torch.Generator().manual_seed(0))
            new, m = task.train_step(state0, batch)
            new_w, m_w = VocoderTask(W.VOC_PLAIN, world=world).train_step(state0, batch)
    finally:
        dist.shutdown(world)
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m_w.items()}
    a, b = tree_leaves(dist.sorted_keys(new)), tree_leaves(dist.sorted_keys(new_w))
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_gloo_two_ranks_on_card_match_one_rank(tmp_path):
    """Two gloo ranks on cuda:0 (subprocesses of tests/torch_dist_worker.py),
    each with one row of the small vocoder's batch, held as the card's step
    is held to the CPU's (test_conan_step_on_card_matches_cpu): losses to the
    one-rank step on the card, rtol 1e-4; the gradients (the first moments
    after a first step) per leaf to the CPU's one-rank float64 step within
    max(1e-3, 4 x the CPU's one-rank fp32 step's worst leaf): at random init
    some of the generator's leaves have norms near 1e-10, and any fp32 route
    moves them by a few 1e-3 (3.2e-3 for the CPU's fp32 step, 3.4e-3 for the
    two ranks on the CPU); the ranks' states bit for bit."""
    _card()
    W = _dist_worker()
    r0, r1 = W.collect(W.start_ranks(str(tmp_path), "card"), timeout=300)
    want = W.run_case("vocoder_plain", None, random=False, device="cuda:0")
    with torch.backends.mkldnn.flags(enabled=False):
        cpu32 = W.run_case("vocoder_plain", None, random=False)
        cpu64 = W.run_case("vocoder_plain", None, random=False, dtype=torch.float64)
    got0, got1 = r0["vocoder_plain"], r1["vocoder_plain"]
    assert got0["metrics"] == got1["metrics"]
    for k, v in want["metrics"][0].items():
        assert got0["metrics"][0][k] == pytest.approx(v, rel=1e-4, abs=0), k

    def rel(a, b):
        a, b = a.astype(np.float64), b.astype(np.float64)
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)

    mu = [p for p in want["state"] if "/mu/" in p]
    assert mu and sorted(got0["state"]) == sorted(mu)
    assert got0["hash"] == got1["hash"] and set(got0["hash"]) == set(want["state"])
    limit = max(1e-3, 4 * max(rel(cpu32["state"][p], cpu64["state"][p]) for p in mu))
    assert max(rel(got0["state"][p], cpu64["state"][p]) for p in mu) <= limit


@pytest.mark.cuda
def test_concurrent_first_use_builds_produce_one_library():
    """With the library gone, two processes that load it at once: one runs
    nvcc under the build lock, the other waits and loads what it built."""
    from conan_tpu_torch.ops import native

    _card()
    native.LIB_PATH.unlink(missing_ok=True)
    script = ("import sys; sys.path.insert(0, %r); from conan_tpu_torch.ops import native; "
              "out = native.build(); native.load(); print('BUILT' if out else 'UP_TO_DATE')"
              % os.path.dirname(TESTS_DIR))
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = sorted(p.communicate(timeout=600)[0].strip().splitlines()[-1] for p in procs)
    assert all(p.returncode == 0 for p in procs), outs
    assert outs == ["BUILT", "UP_TO_DATE"]
    assert native.LIB_PATH.exists()


# the modules ported last: the Emformer's two heads, the flow's dynamic clip
# in a captured step, the profiling helpers and the vocoder micro-harness


@pytest.mark.cuda
def test_emformer_two_heads_on_card_match_cpu():
    """mode="both" on the card: apply against the CPU's on the same weights
    and the card's step chunk by chunk against its apply, both heads to
    1e-4, codes equal."""
    from conan_tpu_torch.checkpoint import tree_map
    from conan_tpu_torch.models.emformer import EmformerConfig, EmformerDistillModel

    dev = _card()
    model = EmformerDistillModel(EmformerConfig(**EMF_SMALL), mode="both")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    mel = torch.randn(2, 6 * 4 + 2, 16, generator=gen)
    cpu = model.apply(params, mel)
    p_dev = tree_map(lambda x: x.to(dev), params)
    full = model.apply(p_dev, mel.to(dev))
    state, steps = model.init_state(2, dev), []
    for s in range(6):
        out, state = model.step(p_dev, state, mel[:, 4 * s:4 * s + 6].to(dev))
        steps.append(out)
    for i, width in enumerate((100, 768)):
        assert full[i].shape == (2, 24, width)
        torch.testing.assert_close(full[i].cpu(), cpu[i], atol=1e-4, rtol=0)
        torch.testing.assert_close(torch.cat([o[i] for o in steps], 1), full[i], atol=1e-4,
                                   rtol=0)
    assert torch.equal(full[0].argmax(-1).cpu(), cpu[0].argmax(-1))


@pytest.mark.cuda
def test_flow_dynamic_clip_in_a_captured_step_equals_eager():
    """StreamingRectifiedFlow.step with dyn_clip captured into a CUDA graph,
    the bounds in static tensors refilled before each replay: each chunk
    equals the eager step with that chunk's bounds (1e-5), and the bounds
    bind."""
    from conan_tpu_torch.checkpoint import tree_map
    from conan_tpu_torch.models.conan import flow as pflow

    dev = _card()
    net = pflow.DiffNet(pflow.DiffNetConfig(in_dims=1, encoder_hidden=32, residual_layers=2,
                                            residual_channels=16, dilation_cycle_length=2))
    stream = pflow.StreamingRectifiedFlow(pflow.RectifiedFlow(net, pflow.ReflowConfig(k_step=6)))
    gen = torch.Generator().manual_seed(0)
    params = net.init(gen)
    params["out_proj"]["w"] = 0.3 * torch.randn(params["out_proj"]["w"].shape, generator=gen)
    params = tree_map(lambda x: x.to(dev), params)
    n = 4
    cond, x0 = torch.randn(n, 1, 4, 32, generator=gen), torch.randn(n, 1, 4, 1, generator=gen)
    lo = -0.3 + 0.1 * torch.rand(n, 1, 4, 1, generator=gen)
    hi = 0.1 + 0.1 * torch.rand(n, 1, 4, 1, generator=gen)
    cond, x0, lo, hi = (t.to(dev) for t in (cond, x0, lo, hi))
    state, eager = stream.init_state(1, dev), []
    for i in range(n):
        y, state = stream.step(params, state, cond[i], x0[i], dyn_clip=(lo[i], hi[i]))
        eager.append(y)
    unclipped, _ = stream.step(params, stream.init_state(1, dev), cond[0], x0[0])
    assert float((eager[0] - unclipped).abs().max()) > 1e-2
    bufs = {"state": stream.init_state(1, dev), "cond": cond[0].clone(), "x0": x0[0].clone(),
            "lo": lo[0].clone(), "hi": hi[0].clone()}

    def chunk():
        return stream.step(params, bufs["state"], bufs["cond"], bufs["x0"],
                           dyn_clip=(bufs["lo"], bufs["hi"]))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chunk()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_buf, new_state = chunk()
        for k, v in new_state.items():
            bufs["state"][k].copy_(v)
    for v in bufs["state"].values():
        v.zero_()
    for i in range(n):
        for name, src in (("cond", cond), ("x0", x0), ("lo", lo), ("hi", hi)):
            bufs[name].copy_(src[i])
        graph.replay()
        torch.testing.assert_close(y_buf, eager[i], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_device_trace_and_sync_on_card(tmp_path):
    """device_trace on the card writes a Chrome trace naming K1's kernel;
    sync leaves no work queued on the card. The profiler misses a launch now
    and then, so a window makes 8 K1 calls and is taken again, twice at
    most, where it recorded none of them."""
    from conan_tpu_torch.utils.profiling import device_trace, sync

    dev = _card()
    wav = torch.randn(1, 81920, device=dev) * 0.2
    kernel = LogmelKernel()
    for attempt in range(3):
        log_dir = tmp_path / f"trace{attempt}"
        with device_trace(str(log_dir)) as prof:
            mels = [kernel(wav, MelConfig()) for _ in range(8)]
            sync({"mel": mels, "wav": [wav]})
            assert torch.cuda.current_stream().query()
        files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
        assert len(files) == 1
        with open(log_dir / files[0]) as f:
            kernels = [e["name"] for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
        recorded = sum("logmel_fft_kernel" in name for name in kernels)
        counted = sum(e.count for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and "logmel_fft_kernel" in e.key)
        assert recorded == counted <= 8
        if recorded:
            break
    assert recorded >= 1


@pytest.mark.cuda
def test_bench_vocoder_on_card(tmp_path, capsys):
    """The micro-harness on the card (CUDA events) on a small vocoder with
    fan-in scaled seeded weights: both lines, consistency OK, exit 0."""
    from conan_tpu_torch.checkpoint import save_checkpoint
    from conan_tpu_torch.infer import bench_vocoder
    from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig, HifiGanGenerator
    from conan_tpu_torch.nn.inits import fan_in_redraw

    _card()
    hp = dict(SMALL["vocoder"], audio_sample_rate=16000)
    gen = torch.Generator().manual_seed(0)
    params = fan_in_redraw(HifiGanGenerator(HifiGanConfig.from_hparams(hp)).init(gen), gen)
    save_checkpoint(str(tmp_path), 0, {"params_g": params}, hp)
    with open(tmp_path / "config.yaml", "w") as f:
        json.dump(hp, f)
    bench_vocoder.main(["--ckpt_dir", str(tmp_path), "--chunks", "8"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("vocoder single-chunk (4 frames = 80 ms audio): p50 ")
    assert lines[1].startswith("incremental-consistency (4 vs 8 frame chunks)")
    assert lines[1].endswith("(OK)")


# K3, the "default" rung's dense conv1d (ops/denseconv.py), with its dx and
# dw: ops.conv.conv1d under training_scope("default") on the card against
# the float64 conv of the bf16-rounded operands (the plain versions, the
# values precision.rounded_dot gives), relative L2 per tensor within 1e-4
# (chip_smoke.py's DENSE_REL: the same exact products summed in fp32 in
# another order). The route before K3 (cuDNN's conv on bf16 tensors, its bf16
# result cast to fp32) lands at 1.6e-3 to 6.6e-3 here: one bf16 rounding of
# each result. (B, T, Ci, Co, K, dilation, pad_l, pad_r): Conan's k=31, a
# ragged causal dilated one, an 80-channel input, T under one 64-row slot
# with a dilation past T, a k=1 conv, the vocoder's 512 -> 2048 upsampler
DENSE_CASES = [(2, 160, 256, 512, 31, 1, 15, 15), (3, 77, 24, 40, 3, 2, 4, 0),
               (2, 300, 80, 160, 5, 1, 2, 2), (1, 13, 64, 64, 11, 5, 50, 0),
               (5, 50, 512, 256, 1, 1, 0, 0), (2, 25, 512, 2048, 16, 1, 15, 0)]


def _dense_operands(case, dev):
    B, T, Ci, Co, K, d, pl, pr = case
    rng = np.random.default_rng(sum(case))
    x = rng.standard_normal((B, T, Ci))
    w = (rng.random((Co, Ci, K)) * 2 - 1) * np.sqrt(3 / (Ci * K))
    b = 0.1 * rng.standard_normal(Co)
    gy = rng.standard_normal((B, T + pl + pr - d * (K - 1), Co))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (x, w, b, gy)]


def _dense_want(x, w, b, gy, case):
    """The plain versions in float64: value, dx, dw, db."""
    from conan_tpu_torch.ops import denseconv as dc

    _B, _T, _Ci, _Co, _K, d, pl, pr = case
    conv = dict(dilation=d, padding=(pl, pr))
    x, w, b, gy = (t.double() for t in (x, w, b, gy))
    return (dc.dense_conv1d_bf16_reference(x, w, b, **conv),
            dc.dense_conv1d_bf16_input_grad_reference(gy, w, x.shape, **conv),
            dc.dense_conv1d_bf16_weight_grad_reference(x, gy, w.shape, **conv), gy.sum((0, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_conv1d_at_default_returns_fp32_results(case):
    """The repair K3 makes: under "default" the dense conv1d and its two
    gradients are JAX's DEFAULT (fp32 results of bf16-rounded operands),
    each launching K3 once."""
    from chip_smoke import DENSE_REL, rel_l2
    from conan_tpu_torch.ops import conv as conv_ops
    from conan_tpu_torch.ops.denseconv import denseconv
    from conan_tpu_torch.ops.precision import training_scope

    dev = _card()
    _B, _T, _Ci, _Co, _K, d, pl, pr = case
    x, w, b, gy = _dense_operands(case, dev)
    before = (denseconv.launches, denseconv.launches_dx, denseconv.launches_dw)
    xx, ww, bb = (t.clone().requires_grad_(True) for t in (x, w, b))
    with training_scope("default", dev):
        y = conv_ops.conv1d(xx, ww, bb, dilation=d, padding=(pl, pr))
        got = (y,) + torch.autograd.grad(y, (xx, ww, bb), gy)
    torch.cuda.synchronize()
    after = (denseconv.launches, denseconv.launches_dx, denseconv.launches_dw)
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, 1]
    assert all(t.dtype == torch.float32 for t in got)
    for name, a, want in zip(("y", "dx", "dw", "db"), got, _dense_want(x, w, b, gy, case)):
        assert rel_l2(a.double(), want) <= DENSE_REL, name


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 400, 1, 128, 15, 1, 7, 7), (2, 60, 1024, 1, 3, 1, 1, 1),
                                  (2, 300, 32, 1, 7, 1, 6, 0)])
def test_dense_conv1d_at_default_without_k3_is_rounded_dot(case):
    """A geometry K3 does not take (one channel in or out: the MSD's first
    and last layers, the generator's conv_post) runs rounded_dot on the
    card: fp32 cuDNN with TF32 off on the rounded operands, its result and
    gradients within 1e-5 of float64 (cuDNN's bf16 conv, cast to fp32, sat
    at ~1e-3), and launches no K3 kernel."""
    from chip_smoke import rel_l2
    from conan_tpu_torch.ops import conv as conv_ops
    from conan_tpu_torch.ops.denseconv import denseconv, dense_kernel_takes
    from conan_tpu_torch.ops.precision import training_scope

    dev = _card()
    _B, _T, Ci, Co, K, d, pl, pr = case
    assert not dense_kernel_takes(Ci, Co, K, d)
    x, w, b, gy = _dense_operands(case, dev)
    before = (denseconv.launches, denseconv.launches_dx, denseconv.launches_dw)
    xx, ww, bb = (t.clone().requires_grad_(True) for t in (x, w, b))
    with training_scope("default", dev):
        y = conv_ops.conv1d(xx, ww, bb, dilation=d, padding=(pl, pr))
        got = (y,) + torch.autograd.grad(y, (xx, ww, bb), gy)
    torch.cuda.synchronize()
    assert (denseconv.launches, denseconv.launches_dx, denseconv.launches_dw) == before
    for name, a, want in zip(("y", "dx", "dw", "db"), got, _dense_want(x, w, b, gy, case)):
        assert rel_l2(a.double(), want) <= 1e-5, name


@pytest.mark.cuda
def test_denseconv_gradients_only_as_asked_and_dw_twice_the_same_bits():
    """x's gradient alone launches K3 dx and no dw, w's alone dw and no dx;
    K3 dw on the same inputs gives the same bits (its splits are added in a
    fixed order, no atomics)."""
    from conan_tpu_torch.ops.denseconv import DenseConvKernel, _bf16_operand
    from conan_tpu_torch.ops.precision import training_scope

    dev = _card()
    case = (4, 700, 128, 256, 7, 3, 18, 0)
    x, w, b, gy = _dense_operands(case, dev)
    kernel = DenseConvKernel()
    conv = dict(dilation=3, padding=(18, 0))
    with training_scope("default", dev):
        xx = x.clone().requires_grad_(True)
        torch.autograd.grad(kernel(xx, w, b, **conv), xx, gy)
        assert (kernel.launches, kernel.launches_dx, kernel.launches_dw) == (1, 1, 0)
        ww = w.clone().requires_grad_(True)
        torch.autograd.grad(kernel(x, ww, None, **conv), ww, gy)
        assert (kernel.launches, kernel.launches_dx, kernel.launches_dw) == (2, 1, 1)
    xb, gyb = _bf16_operand(x, "x"), _bf16_operand(gy, "gy")
    first = kernel.weight_grad(xb, gyb, w.shape, **conv)
    assert torch.equal(first, kernel.weight_grad(xb, gyb, w.shape, **conv))


@pytest.mark.cuda
def test_denseconv_launch_failure_raises(monkeypatch):
    """No silent route: a plan the library was not built for makes the C
    entry refuse the launch, and the wrapper raises (no cuDNN fallback)."""
    from conan_tpu_torch.ops import denseconv as dc
    from conan_tpu_torch.ops.precision import training_scope

    dev = _card()
    x, w, b, _gy = _dense_operands((2, 100, 64, 64, 3, 1, 1, 1), dev)
    kernel = dc.DenseConvKernel()
    monkeypatch.setattr(dc, "dense_plan", lambda *args: dc.DensePlan(32, 2, 1, 64, 4, 2, 0, 1))
    with training_scope("default", dev), pytest.raises(RuntimeError, match="launch failed"):
        kernel(x, w, b, padding=(1, 1))
    assert kernel.launches == 0


# K3's kernels at the edges of their plans, each result against the float64
# plain version within DENSE_REL and dw twice the same bits: (B, T, Ci, Co,
# K, dilation, pad_l, pad_r, dw split): K = 1 (dw's tiles split), K = 31 in
# one window, the conv2d fold's 8-channel input at dilation 40, 32 and 80
# channels (tiles and chunks past the channels), 1024 -> 1024 on a few
# short rows (dw unsplit, the forward's
# tiles of one slot a warpgroup), a left pad past dilation*(K-1) (dx's
# windows start past its rows), windows past a TMA box (taps in runs)
K3_EDGE_CASES = [(2, 300, 256, 512, 1, 1, 0, 0, True), (2, 150, 256, 512, 31, 1, 15, 15, None),
                 (3, 700, 8, 128, 2, 40, 40, 0, None), (2, 1000, 32, 32, 11, 5, 50, 0, True),
                 (2, 300, 80, 160, 5, 1, 2, 2, None), (2, 200, 160, 80, 1, 1, 0, 0, True),
                 (18, 110, 1024, 1024, 5, 1, 2, 2, False), (2, 120, 64, 64, 3, 1, 5, 0, None),
                 (1, 400, 16, 24, 5, 60, 240, 0, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_EDGE_CASES)
def test_denseconv_kernels_at_their_plans_edges(case):
    """K3, its dx and dw through the wrapper on the card, one launch each,
    against the plain versions in float64 within DENSE_REL; dw a second
    time the same bits (split sums added in a fixed order, no atomics); the
    dw plan split or not as the case says."""
    from chip_smoke import DENSE_REL, rel_l2
    from conan_tpu_torch.ops import denseconv as dc
    from conan_tpu_torch.ops.groupconv import sm_count

    dev = _card()
    B, T, Ci, Co, K, d, pl, pr, split = case
    x, w, b, gy = _dense_operands(case[:8], dev)
    conv = dict(dilation=d, padding=(pl, pr))
    plan = dc.dense_wgrad_plan(B, gy.shape[1], Ci, Co, K, d, sm_count(dev.index or 0))
    if split is not None:
        assert (plan.splits > 1) == split
    kernel = dc.DenseConvKernel()
    xb, gyb = dc._bf16_operand(x, "x"), dc._bf16_operand(gy, "gy")
    got = (kernel.launch(xb, w, b, **conv), kernel.input_grad(gyb, w, x.shape, **conv),
           kernel.weight_grad(xb, gyb, w.shape, **conv))
    again = kernel.weight_grad(xb, gyb, w.shape, **conv)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.launches_dx, kernel.launches_dw) == (1, 1, 2)
    want = _dense_want(x, w, b, gy, case[:8])[:3]
    for name, a, ref in zip(("y", "dx", "dw"), got, want):
        assert a.dtype == torch.float32 and a.shape == ref.shape, name
        assert rel_l2(a.double(), ref) <= DENSE_REL, name
    assert torch.equal(got[2], again)


# The rest of the "default" rung (ops/conv.py's folds, ops/precision.py's
# fp32-output product): conv2d and conv_transpose1d folded onto one
# stride-1 conv1d (K3 where it takes the fold's geometry, else rounded_dot:
# fp32 cuDNN with TF32 off), and every dot as one cuBLAS product with an fp32
# result. Each value and gradient against the float64 op on the rounded
# operands (the incoming gradient rounded; the bias's gradient is the plain
# sum), relative L2 within DENSE_REL through K3 and 1e-5 elsewhere. The
# route before (cuDNN's or cuBLAS's op on bf16 tensors, its bf16 result
# cast to fp32) lands at ~1.5e-3: one bf16 rounding of each result.
OTHER_REL = 1e-5


def _default_rung_results(fn, shapes, grads, seed, dev):
    """(the route's value and gradients at "default", the float64 ones on
    the rounded operands, the K3 launches it made) for fn(a, b[, bias]) on
    seeded operands of ``shapes``; ``grads``: which inputs take a gradient."""
    from conan_tpu_torch.ops.denseconv import denseconv
    from conan_tpu_torch.ops.precision import training_scope

    rng = np.random.default_rng(seed)
    ins = [torch.from_numpy((rng.standard_normal(s) / (np.sqrt(np.prod(s[1:])) if i == 1
                                                       else 1)).astype(np.float32)).to(dev)
           for i, s in enumerate(shapes)]
    before = (denseconv.launches, denseconv.launches_dx, denseconv.launches_dw)
    xs = [t.clone().requires_grad_(want) for t, want in zip(ins, grads)]
    with training_scope("default", dev):
        y = fn(*xs)
    gy = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32)).to(dev)
    got = (y,) + torch.autograd.grad(y, [x for x in xs if x.requires_grad], gy)
    torch.cuda.synchronize()
    launches = [a - b for a, b in zip((denseconv.launches, denseconv.launches_dx,
                                       denseconv.launches_dw), before)]
    rs = [(t.to(torch.bfloat16).double() if i < 2 else t.double()).requires_grad_(want)
          for i, (t, want) in enumerate(zip(ins, grads))]
    y64 = fn(*rs)       # outside any rung: the float64 op
    g64 = gy.to(torch.bfloat16).double()
    want = [y64.detach()]
    for i, r in enumerate(rs):
        if r.requires_grad:
            want.append(torch.autograd.grad(y64, r, g64 if i < 2 else gy.double(),
                                            retain_graph=True)[0])
    return got, want, launches


# (B, C, H, W, Co, (kh, kw), stride, padding): the MPD at period 2 and 11
# (layer 1's 2 channels, layers 2-4 at stride 3, layer 5, post), the window
# discriminators' c0 (32 x 80) and c1 at Conan's width
CONV2D_CASES = [(2, 2, 400, 2, 32, (5, 1), (3, 1), (2, 0)),
                (2, 32, 134, 2, 128, (5, 1), (3, 1), (2, 0)),
                (2, 128, 45, 11, 512, (5, 1), (3, 1), (2, 0)),
                (2, 512, 15, 11, 1024, (5, 1), (3, 1), (2, 0)),
                (2, 1024, 9, 7, 1024, (5, 1), (1, 1), (2, 0)),
                (2, 1024, 9, 5, 1, (3, 1), (1, 1), (1, 0)),
                (3, 1, 32, 80, 128, (3, 3), (2, 2), (1, 1)),
                (3, 128, 16, 40, 128, (3, 3), (2, 2), (1, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV2D_CASES)
def test_conv2d_at_default_returns_fp32_results(case):
    """conv2d under "default" on the card: fp32 value, dx, dw and db of the
    rounded operands, each fold K3 takes launching K3, dx and dw once, the
    others (one or two channels in, one out) none."""
    from chip_smoke import DENSE_REL, rel_l2
    from conan_tpu_torch.ops import conv as conv_ops
    from conan_tpu_torch.ops.denseconv import dense_kernel_takes

    dev = _card()
    B, C, H, W, Co, k, s, pad = case
    got, want, launches = _default_rung_results(
        lambda x, w, b: conv_ops.conv2d(x, w, b, stride=s, padding=pad),
        [(B, C, H, W), (Co, C, *k), (Co,)], (True, True, True), sum(case[:5]), dev)
    qh, qw = -(-k[0] // s[0]), -(-k[1] // s[1])
    Wo = (W + 2 * pad[1] - k[1]) // s[1] + 1
    takes = dense_kernel_takes(qw * s[0] * s[1] * C, Co, qh, Wo)
    assert launches == ([1, 1, 1] if takes else [0, 0, 0])
    for name, a, b in zip(("y", "dx", "dw", "db"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert rel_l2(a.double(), b) <= (DENSE_REL if takes else OTHER_REL), name


# (B, T, Cin, Cout, K, stride, padding, output_padding): the non-causal
# generator's four ups at 512 initial channels, the nn upsampler's first
TRANSPOSED_CASES = [(2, 50, 512, 256, 16, 8, 4, 0), (2, 400, 256, 128, 11, 5, 3, 0),
                    (2, 2000, 128, 64, 8, 4, 2, 0), (2, 8000, 64, 32, 4, 2, 1, 0),
                    (2, 57, 512, 256, 16, 8, 0, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRANSPOSED_CASES)
def test_conv_transpose1d_at_default_returns_fp32_results(case):
    from chip_smoke import DENSE_REL, rel_l2
    from conan_tpu_torch.ops import conv as conv_ops

    dev = _card()
    B, T, Ci, Co, K, u, pad, op = case
    conv = dict(stride=u, padding=pad, output_padding=op)

    def fn(x, w, b):
        if x.dtype == torch.float64:
            return torch.nn.functional.conv_transpose1d(x.transpose(1, 2), w, b, **conv
                                                        ).transpose(1, 2)
        return conv_ops.conv_transpose1d(x, w, b, **conv)

    got, want, launches = _default_rung_results(fn, [(B, T, Ci), (Ci, Co, K), (Co,)],
                                                (True, True, True), sum(case), dev)
    assert launches == [1, 1, 1]
    for name, a, b in zip(("y", "dx", "dw", "db"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert rel_l2(a.double(), b) <= DENSE_REL, name


# (what, a's shape, b's shape): dense's x @ wᵀ (the reshape to one [M, K]
# product), the STFT loss's frames @ basis, the conditional MPD's mel
# upsampler, the VQ EMA's onehotᵀ @ x, and the four einsums
DOT_CASES = [("dense", (4, 300, 256), (256, 1024)), ("stft", (18, 51, 1024), (1024, 1026)),
             ("cond", (18, 25, 80), (80, 640)), ("ema", (512, 2400), (2400, 256)),
             ("bqhd,bkhd->bhqk", (4, 200, 2, 128), (4, 150, 2, 128)),
             ("bhqk,bkhd->bqhd", (4, 2, 200, 150), (4, 150, 2, 128)),
             ("btd,nd->btn", (4, 300, 256), (512, 256)),
             ("bqk,bkh->bqh", (4, 300, 150), (4, 150, 256))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DOT_CASES, ids=[c[0] for c in DOT_CASES])
def test_dots_at_default_return_fp32_results(case, monkeypatch):
    """Every dot site's product under "default" on the card: three cuBLAS
    products of bf16 operands with fp32 results (forward, both gradients),
    each within 1e-5 of float64 on the rounded operands; no K3."""
    from chip_smoke import rel_l2
    from conan_tpu_torch.ops import precision

    dev = _card()
    what, a_shape, b_shape = case
    products = []
    real = precision._product

    def product(a, b):
        products.append((a.dtype, b.dtype))
        return real(a, b)

    monkeypatch.setattr(precision, "_product", product)

    def fn(a, b):
        if a.dtype == torch.float64:
            return torch.einsum(what, a, b) if "->" in what else a @ b
        return precision.einsum_at_rung(what, a, b) if "->" in what else \
            precision.dot_at_rung(a, b)

    got, want, launches = _default_rung_results(fn, [a_shape, b_shape], (True, True), len(what),
                                                dev)
    assert launches == [0, 0, 0] and products == [(torch.bfloat16, torch.bfloat16)] * 3
    for name, a, b in zip(("y", "da", "db"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert rel_l2(a.double(), b) <= OTHER_REL, name
