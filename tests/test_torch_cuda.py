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


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(15))
def test_groupconv_bf16_matches_plain_version(index):
    from chip_smoke import BF16_GRAD_REL, rel_l2
    from conan_tpu_torch.ops.groupconv import grouped_conv1d_bf16_reference
    from conan_tpu_torch.ops.precision import rounded_dot, training_scope

    dev = _card()
    _scale, T, ci, co, k, s, g, pd = _msd_geometries()[index]
    kernel = GroupConvKernel()
    rng = np.random.default_rng(index)
    x = torch.from_numpy(rng.standard_normal((2, T, ci)).astype(np.float32)).to(dev)
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
