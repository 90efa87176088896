"""The port's RMVPE F0 extractor (``conan_tpu_torch/models/rmvpe.py``), its
CLI (``data/extract_f0.py``) and the eval metrics (``metrics/eval_metrics.py``)
against the JAX package's, on the CPU.

Weights: the reference's state dict, written by the port's
``E2E0.params_to_torch`` from its seeded init with numpy BN statistics and
biases; JAX's ``params_from_torch`` and ``apply`` on it are the check that
the names and shapes are the reference's. Tolerances: the salience at atol
2e-5, rtol 1e-4 (JAX's own golden bound, tests/test_rmvpe.py); the log-mel
1e-4 (fp32 DFT products in other orders); the decoders exactly; F0 from
audio with the same voiced frames and within 1e-3 relative. An argmax flip
between the packages would show as an F0 off by a bin, and is reported by
the assertion, not seeded away.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from conan_tpu.data import extract_f0 as jextract
from conan_tpu.metrics import eval_metrics as jmetrics
from conan_tpu.models import rmvpe as jrmvpe

from conan_tpu_torch.data import extract_f0
from conan_tpu_torch.metrics import eval_metrics
from conan_tpu_torch.models import rmvpe

from tests.torch_port_util import one_torch_thread  # noqa: F401

SR = 16000
CONFIG = os.path.join(os.path.dirname(__file__), "..", "egs", "conan_emformer.yaml")


def _state_dict(cfg: rmvpe.RMVPEConfig, seed: int) -> dict:
    """The reference E2E0's state dict (numpy): the port's seeded init, its
    BN statistics and non-GRU biases redrawn so that none is trivial."""
    model = rmvpe.E2E0(cfg)
    sd = {k: v.numpy() for k, v in
          model.params_to_torch(model.init(torch.Generator().manual_seed(seed))).items()}
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        if k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith(("running_mean", "bn.bias", "1.bias", "4.bias")):
            sd[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return sd


def _voiced(seconds: float, seed: int) -> np.ndarray:
    """Harmonics of a gliding 100-220 Hz F0 with a syllable envelope, plus
    noise (chip_smoke.py's synth_wav)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 160 + 60 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t + rng.uniform(0, 6))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(np.sin(k * phase) / k for k in range(1, 20))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    return (0.1 * env * voiced + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def _same_f0(got: np.ndarray, want: np.ndarray):
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0)


@pytest.mark.parametrize("n", [16000, 8123])
def test_mel_spectrogram_matches_jax(n):
    wav = (np.random.default_rng(n).standard_normal((2, n)) * 0.2).astype(np.float32)
    want = np.asarray(jrmvpe.mel_spectrogram(jnp.asarray(wav), 160))
    got = rmvpe.mel_spectrogram(torch.from_numpy(wav), 160).numpy()
    assert got.shape == want.shape == (2, 128, n // 160 + 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n_blocks,batch,frames", [(1, 2, 32), (4, 1, 64)])
def test_e2e0_matches_jax(n_blocks, batch, frames):
    """The network at n_blocks 1 and at the full config: the port's mapper
    equals JAX's exactly, JAX's gives the port's tree back from the port's
    export, and the salience agrees."""
    jcfg = jrmvpe.RMVPEConfig(n_blocks=n_blocks)
    cfg = rmvpe.RMVPEConfig(n_blocks=n_blocks)
    sd = _state_dict(cfg, seed=n_blocks)
    jp = jrmvpe.E2E0(jcfg).params_from_torch(sd)
    model = rmvpe.E2E0(cfg)
    p = model.params_from_torch(sd, device="cpu")
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, p, is_leaf=torch.is_tensor))
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, p, is_leaf=torch.is_tensor))):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = jrmvpe.E2E0(jcfg).params_from_torch(
        {k: v.numpy() for k, v in model.params_to_torch(p).items()})
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    mel = np.random.default_rng(frames).standard_normal((batch, 128, frames)).astype(np.float32)
    want = np.asarray(jax.jit(jrmvpe.E2E0(jcfg).apply)(jp, mel))
    with torch.no_grad():
        got = model.apply(p, torch.from_numpy(mel)).numpy()
    assert got.shape == (batch, frames, 360)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_decoders_match_jax():
    rng = np.random.default_rng(3)
    hidden = (rng.random((2, 40, 360)) * 0.5).astype(np.float32)
    hidden[1, :5] *= 0.02                                   # unvoiced frames
    np.testing.assert_array_equal(rmvpe.to_local_average_f0(hidden),
                                  jrmvpe.to_local_average_f0(hidden))
    np.testing.assert_array_equal(rmvpe.to_viterbi_f0(hidden), jrmvpe.to_viterbi_f0(hidden))
    prob, trans = rng.random((6, 9)) + 1e-3, rng.random((6, 6)) + 1e-3
    trans /= trans.sum(1, keepdims=True)
    np.testing.assert_array_equal(rmvpe._viterbi(prob, trans), jrmvpe._viterbi(prob, trans))
    f0 = np.array([0, 500, 500, 0, 200, 200, 200, 0, 2000, 100, 40, 300], float)
    for gap in (1, 2, 3):
        np.testing.assert_array_equal(rmvpe.postprocess_f0(f0, min_gap=gap),
                                      jrmvpe.postprocess_f0(f0, min_gap=gap))
    curve = (rng.random(50) * 300).astype(np.float32)
    for target, length in ((0.02, 30), (0.02, 20), (0.016, 70)):
        got = rmvpe.resample_align_curve(curve, 0.01, target, length)
        np.testing.assert_array_equal(got, jrmvpe.resample_align_curve(curve, 0.01, target,
                                                                       length))
        assert got.dtype == np.float32


@pytest.mark.parametrize("use_viterbi", [False, True])
def test_get_pitch_matches_jax(use_viterbi):
    """RMVPE end to end at n_blocks 1 on a 0.5 s voiced clip: the decoded
    10 ms curve, then ``get_pitch`` at the Conan hop (320): the same voiced
    frames, F0 within 1e-3 relative. (With random weights the Viterbi path
    falls outside 50-1000 Hz or into glitches, so its curve is all unvoiced
    after ``postprocess_f0``.)"""
    sd = _state_dict(rmvpe.RMVPEConfig(n_blocks=1), seed=5)
    jm = jrmvpe.RMVPE(jrmvpe.E2E0(jrmvpe.RMVPEConfig(n_blocks=1)).params_from_torch(sd),
                      cfg=jrmvpe.RMVPEConfig(n_blocks=1))
    cfg = rmvpe.RMVPEConfig(n_blocks=1)
    pm = rmvpe.RMVPE(rmvpe.E2E0(cfg).params_from_torch(sd, device="cpu"), cfg=cfg,
                     device="cpu")
    wav = _voiced(0.5, seed=6)
    n = len(wav) // 320 + 1
    raw = pm.infer_from_audio(wav, use_viterbi=use_viterbi)
    assert raw.shape == (len(wav) // 160 + 1,) and len(np.unique(raw)) > len(raw) // 2
    _same_f0(raw, jm.infer_from_audio(wav, use_viterbi=use_viterbi))
    want, want_uv = jm.get_pitch(wav, SR, 320, n, use_viterbi=use_viterbi)
    got, got_uv = pm.get_pitch(wav, SR, 320, n, use_viterbi=use_viterbi)
    assert got.shape == (n,)
    if not use_viterbi:
        assert 0 < (got > 0).sum() < n                    # voiced and unvoiced frames
    _same_f0(got, want)
    np.testing.assert_array_equal(got_uv, want_uv)
    with pytest.raises(ValueError, match="resample"):
        pm.get_pitch(wav, 22050, 320, n)


def _corpus(root, lengths):
    """A processed dir whose metadata names one wav per length."""
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir)
    items = []
    for i, n in enumerate(lengths):
        fn = os.path.join(wav_dir, f"spk_{i}.wav")
        wavfile.write(fn, SR, _voiced(n / SR, seed=10 + i))
        items.append({"item_name": f"spk_{i}", "wav_fn": fn})
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump(items, f)
    return items


def test_extract_f0_cli_matches_jax(tmp_path):
    """Both CLIs on the same fake full-config rmvpe.pt over three clips of
    0.3-0.5 s: the same files (frames len // hop + 1, float32), the same
    voiced frames, F0 within 1e-3 relative; a second run writes nothing."""
    ckpt = str(tmp_path / "rmvpe.pt")
    sd = _state_dict(rmvpe.RMVPEConfig(), seed=7)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    lengths = (4800, 6431, 8000)
    runs = {}
    for name, main in (("jax", jextract.main), ("port", extract_f0.main)):
        root = str(tmp_path / name)
        items = _corpus(root, lengths)
        argv = ["--config", CONFIG, "--rmvpe_ckpt", ckpt,
                "--hparams", f"processed_data_dir={root}"]
        main(argv + (["--device", "cpu"] if name == "port" else []))
        runs[name] = [np.load(extract_f0.f0_path(it["wav_fn"])) for it in items]
    assert extract_f0.main(argv + ["--device", "cpu"]) == 0
    for got, want, n in zip(runs["port"], runs["jax"], lengths):
        assert got.dtype == np.float32 and got.shape == want.shape == (n // 320 + 1,)
        _same_f0(got, want)


def test_eval_metrics_match_jax():
    rng = np.random.default_rng(8)
    a = rng.standard_normal(23)
    b = rng.standard_normal(17)
    for warp in (1, 2):
        for got, want in zip(eval_metrics.accelerated_dtw(a, b, warp=warp),
                             jmetrics.accelerated_dtw(a, b, warp=warp)):
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                np.testing.assert_array_equal(g, w)
    f0_a = np.abs(rng.standard_normal(40)) * 100 + 80
    f0_b = np.abs(rng.standard_normal(35)) * 100 + 80
    f0_a[:6] = f0_b[10:14] = 0
    assert eval_metrics.pitch_dtw_distance(f0_a, f0_b) == jmetrics.pitch_dtw_distance(f0_a, f0_b)
    assert np.isnan(eval_metrics.pitch_dtw_distance(f0_a, np.zeros(5)))
    attn = rng.random((2, 30, 12))
    attn /= attn.sum(-1, keepdims=True)
    np.testing.assert_array_equal(eval_metrics.focus_rate(attn), jmetrics.focus_rate(attn))
    np.testing.assert_array_equal(eval_metrics.phone_coverage_rate(attn),
                                  jmetrics.phone_coverage_rate(attn))
    ks, lens = np.array([0.4, 0.5]), np.array([30, 24])
    for got, want in zip(eval_metrics.diagonal_focus_rate(attn, ks, lens),
                         jmetrics.diagonal_focus_rate(attn, ks, lens)):
        np.testing.assert_array_equal(got, want)
    img = rng.standard_normal((20, 30))
    assert eval_metrics.laplace_var(img) == jmetrics.laplace_var(img)
    mel = rng.standard_normal((40, 80)).astype(np.float32) - 4
    other = mel + 0.3 * rng.standard_normal(mel.shape).astype(np.float32)
    got = eval_metrics.mel_ssim_metric(mel, other, device="cpu")
    assert 0 < got < 1
    np.testing.assert_allclose(got, jmetrics.mel_ssim_metric(mel, other), atol=1e-5)


def test_entry_points_default_to_card():
    """``mel_ssim_metric`` and ``RMVPE``, like every entry point of the port,
    run on the card unless the caller passes ``device="cpu"``."""
    if not torch.cuda.is_available():
        mel = np.zeros((20, 80), np.float32)
        with pytest.raises(RuntimeError, match="CUDA"):
            eval_metrics.mel_ssim_metric(mel, mel)
        cfg = rmvpe.RMVPEConfig(n_blocks=1)
        params = rmvpe.E2E0(cfg).init(torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="CUDA"):
            rmvpe.RMVPE(params, cfg=cfg)
