"""The PyTorch port's streaming engine end to end against the JAX package's,
the r5 deploy checkpoints read by the port, and the port's import boundary.

Tolerances: waveforms atol 1e-4, the bound tests/test_streaming_engine.py
holds streaming to offline with (fp32 in both packages, sums in other
orders, through tanh-bounded output); content codes exactly equal.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_tpu.infer.streaming import StreamingVoiceConversion as JEngine
from conan_tpu.models.conan.model import Conan as JConan
from conan_tpu.models.emformer import EmformerDistillModel as JEmformer
from conan_tpu.models.vocoder.hifigan import HifiGanGenerator as JHifiGan

from conan_tpu_torch.checkpoint import load_ckpt_state, params_from_jax
from conan_tpu_torch.infer.build import build_engine, write_random_checkpoints
from conan_tpu_torch.infer.streaming import StreamingVoiceConversion
from conan_tpu_torch.models.conan.model import Conan
from conan_tpu_torch.models.emformer import EmformerDistillModel
from conan_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from conan_tpu_torch.ops.precision import precision_scope

from tests.torch_port_util import SMALL, leaf_paths, numpy_params, port_config
from tests.torch_port_util import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = {name: os.path.join(REPO, "checkpoints", f"soak_r5_{name}", "deploy")
          for name in ("conan", "emf", "voc")}
HOP = 320


def _small_params():
    conan = JConan(SMALL.conan)
    return (numpy_params(JEmformer(SMALL.emformer).init, 10), numpy_params(conan.init, 11),
            numpy_params(conan.init_vq_state, 12), numpy_params(JHifiGan(SMALL.vocoder).init, 13))


def test_small_engine_matches_jax_and_streams_as_offline(rng):
    p_emf, p_conan, vq, p_voc = _small_params()
    src = (rng.standard_normal(HOP * 24) * 0.1).astype(np.float32)
    ref = (rng.standard_normal(HOP * 40) * 0.1).astype(np.float32)
    jax_wav, jax_codes = JEngine(SMALL, p_emf, p_conan, vq, p_voc).infer_once(
        src, ref, collect_codes=True)
    eng = StreamingVoiceConversion(port_config(SMALL), *[params_from_jax(t, "cpu") for t in
                                                         (p_emf, p_conan, vq, p_voc)],
                                   device="cpu")
    wav, codes = eng.infer_once(src, ref, collect_codes=True)
    assert wav.shape == jax_wav.shape == (1, (len(src) // HOP + 1) * HOP)
    np.testing.assert_array_equal(codes, jax_codes)
    np.testing.assert_allclose(wav, jax_wav, atol=1e-4)
    np.testing.assert_allclose(eng.infer_offline(src, ref), wav, atol=1e-4)
    # a batch of two streams: each equals its own run
    both = eng.infer_once(np.stack([src, src[::-1].copy()]), np.stack([ref, ref]))
    np.testing.assert_allclose(both[:1], wav, atol=1e-4)


def _small_engines(**kw):
    trees = _small_params()
    return (JEngine(SMALL, *trees),
            StreamingVoiceConversion(port_config(SMALL), *[params_from_jax(t, "cpu")
                                                           for t in trees], device="cpu", **kw))


def test_scan_bucketed_matches_jax(rng):
    """infer_once(use_scan=True, bucket_lengths=True), the batch-conversion
    call of run_vc, against JAX's lax.scan without bucket_lengths: the port
    pads only the source (exact), where JAX's bucketing also zero-pads the
    reference, which moves its output on these weights (nonzero LayerNorm
    biases). Codes equal, waveform within 1e-4."""
    jeng, eng = _small_engines()
    src = (rng.standard_normal(HOP * 13) * 0.1).astype(np.float32)
    ref = (rng.standard_normal(HOP * 11) * 0.1).astype(np.float32)
    want, want_codes = jeng.infer_once(src, ref, collect_codes=True, use_scan=True)
    wav, codes = eng.infer_once(src, ref, collect_codes=True, use_scan=True,
                                bucket_lengths=True)
    assert wav.shape == want.shape == (1, 14 * HOP)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_allclose(wav, want, atol=1e-4)


def _port_init_engine(seed: int = 1) -> StreamingVoiceConversion:
    """The SMALL engine with the port's own seeded init (the JAX package's
    distributions: LayerNorm scales 1 and biases 0)."""
    gen = torch.Generator().manual_seed(seed)
    cfg = port_config(SMALL)
    conan = Conan(cfg.conan)
    return StreamingVoiceConversion(
        cfg, EmformerDistillModel(cfg.emformer).init(gen), conan.init(gen),
        conan.init_vq_state(gen), HifiGanGenerator(cfg.vocoder).init(gen), device="cpu")


def test_bucketed_lengths_identical_output(rng):
    """bucket_lengths pads the scan path's and offline source with edge
    frames (every source-side op is causal) and leaves the reference as it
    is; on the package's own init the output does not change, streaming and
    offline, as tests/test_streaming_engine.py holds JAX's (1e-6, same
    init)."""
    eng = _port_init_engine()
    src = (rng.standard_normal(HOP * 13) * 0.1).astype(np.float32)
    ref = (rng.standard_normal(HOP * 11) * 0.1).astype(np.float32)
    wav_a, codes_a = eng.infer_once(src, ref, collect_codes=True, use_scan=True)
    wav_b, codes_b = eng.infer_once(src, ref, collect_codes=True, use_scan=True,
                                    bucket_lengths=True)
    np.testing.assert_array_equal(codes_a, codes_b)
    np.testing.assert_allclose(wav_b, wav_a, atol=1e-6)
    wav_e = eng.infer_once(src, ref, bucket_lengths=True)       # eager: the ref alone
    np.testing.assert_allclose(wav_e, wav_a, atol=1e-6)
    off_a, off_codes_a = eng.infer_offline(src, ref, collect_codes=True)
    off_b, off_codes_b = eng.infer_offline(src, ref, collect_codes=True, bucket_lengths=True)
    np.testing.assert_array_equal(off_codes_a, off_codes_b)
    np.testing.assert_allclose(off_b, off_a, atol=1e-6)
    assert eng._p2bucket(1) == 64 and eng._p2bucket(64) == 64 and eng._p2bucket(65) == 128


def test_bucketed_reference_is_not_padded_on_nonzero_layernorm_biases(rng):
    """On weights whose LayerNorm biases are nonzero (seeded numpy, as
    trained weights have them), bucket_lengths leaves the output as it is:
    the reference is not padded, so no zero frame becomes an LN bias that
    the reference encoders' convs read. The scan path, bucketed against
    unbucketed: codes equal, waveform within 1e-5; offline likewise."""
    _, eng = _small_engines()
    ln_bias = eng.p_conan["global_encoder"]["blocks"][0][0]["norm"]["bias"]
    assert float(ln_bias.abs().max()) > 0.05
    src = (rng.standard_normal(HOP * 13) * 0.1).astype(np.float32)
    ref = (rng.standard_normal(HOP * 11) * 0.1).astype(np.float32)
    wav_a, codes_a = eng.infer_once(src, ref, collect_codes=True, use_scan=True)
    wav_b, codes_b = eng.infer_once(src, ref, collect_codes=True, use_scan=True,
                                    bucket_lengths=True)
    np.testing.assert_array_equal(codes_b, codes_a)
    np.testing.assert_allclose(wav_b, wav_a, atol=1e-5, rtol=0)
    off_a = eng.infer_offline(src, ref)
    off_b = eng.infer_offline(src, ref, bucket_lengths=True)
    np.testing.assert_allclose(off_b, off_a, atol=1e-5, rtol=0)


def test_two_utterances_in_a_row_equal_fresh_engines(rng):
    """Each call starts from init_state: a second utterance through the same
    engine (scan and eager) equals a fresh engine's, and does not continue
    the first one's state."""
    srcs = [(rng.standard_normal(HOP * n) * 0.1).astype(np.float32) for n in (13, 9)]
    ref = (rng.standard_normal(HOP * 11) * 0.1).astype(np.float32)
    _, eng = _small_engines()
    for use_scan in (True, False):
        got = [eng.infer_once(s, ref, use_scan=use_scan, bucket_lengths=True) for s in srcs]
        for src, wav in zip(srcs, got):
            _, fresh = _small_engines()
            np.testing.assert_array_equal(
                wav, fresh.infer_once(src, ref, use_scan=use_scan, bucket_lengths=True))


def test_f0_noise_shape_is_checked(rng):
    _, eng = _small_engines()
    src = (rng.standard_normal(HOP * 7) * 0.1).astype(np.float32)
    with pytest.raises(ValueError, match="f0_noise"):
        eng.infer_once(src, src, f0_noise=np.zeros((1, 7, 1), np.float32))


def _small_hparams():
    mel = dict(audio_sample_rate=16000, fft_size=1024, hop_size=320, win_size=1024,
               fmin=80, fmax=7600, audio_num_mel_bins=80)
    return {
        "conan": dict(mel, hidden_size=32, kernel_size=3, silent_token=57, style=True,
                      nVQ=16, f0_gen="orig", predictor_kernel=5, dec_dilations=[1, 1],
                      dec_kernel_size=5, layers_in_block=1, serving_precision="high"),
        "emformer": dict(emformer_layers=1, chunk_size=80, right_context=2),
        "vocoder": dict(upsample_initial_channel=16, upsample_rates=[8, 5, 4, 2],
                        upsample_kernel_sizes=[16, 10, 8, 4], resblock_kernel_sizes=[3],
                        resblock_dilation_sizes=[[1, 3]]),
    }


def test_build_engine_from_random_checkpoints(tmp_path, rng):
    """Seeded random checkpoint dirs load through build_engine; an explicit
    "exact" wins over the checkpoint's serving_precision hparam, and None
    takes the hparam."""
    dirs = write_random_checkpoints(str(tmp_path), _small_hparams(), seed=0)
    eng = build_engine(*dirs, serving_precision="exact", device="cpu")
    assert eng.serving_precision == "exact"
    assert build_engine(*dirs, device="cpu").serving_precision == "high"
    assert eng.cfg.emformer.num_layers == 1 and eng.cfg.vocoder.upsample_initial_channel == 16
    src = (rng.standard_normal(HOP * 10) * 0.1).astype(np.float32)
    ref = (rng.standard_normal(HOP * 12) * 0.1).astype(np.float32)
    wav, codes = eng.infer_once(src, ref, collect_codes=True)
    assert np.isfinite(wav).all() and codes.shape == (1, 11)
    np.testing.assert_allclose(eng.infer_offline(src, ref), wav, atol=1e-4)
    with pytest.raises(ValueError):
        build_engine(*dirs, serving_precision="turbo", device="cpu")
    # an acoustic config that names a vocoder the port does not have
    hparams = _small_hparams()
    hparams["conan"]["vocoder"] = "HifiGAN_NSF"
    with pytest.raises(NotImplementedError, match="HifiGAN_NSF"):
        build_engine(*write_random_checkpoints(str(tmp_path / "nsf"), hparams), device="cpu")


def test_serving_rungs(rng):
    """On the CPU the TF32 flags change nothing, so "high" equals "exact",
    and both stream as they run offline. "fast" runs the acoustic model and
    vocoder under bf16 autocast: its waveform is finite fp32 of the same
    shape, but neither equal to offline nor close to "exact" on these random
    weights (they amplify bf16 rounding; how fast tracks exact on trained
    weights is not measured here); the Emformer runs fp32 on every rung, so
    the codes equal exact's."""
    p_emf, p_conan, vq, p_voc = [params_from_jax(t, "cpu") for t in _small_params()]
    src = (rng.standard_normal(HOP * 16) * 0.1).astype(np.float32)
    ref = (rng.standard_normal(HOP * 20) * 0.1).astype(np.float32)
    out = {}
    for rung in ("exact", "high", "fast"):
        eng = StreamingVoiceConversion(port_config(SMALL), p_emf, p_conan, vq, p_voc,
                                       serving_precision=rung, device="cpu")
        out[rung] = eng.infer_once(src, ref, collect_codes=True)
        wav_off, codes_off = eng.infer_offline(src, ref, collect_codes=True)
        np.testing.assert_array_equal(out[rung][1], codes_off)
        if rung != "fast":
            np.testing.assert_allclose(out[rung][0], wav_off, atol=1e-4)
    np.testing.assert_array_equal(out["high"][0], out["exact"][0])
    np.testing.assert_array_equal(out["fast"][1], out["exact"][1])
    wav_fast = out["fast"][0]
    assert wav_fast.dtype == np.float32 and wav_fast.shape == out["exact"][0].shape
    assert np.isfinite(wav_fast).all()


def test_infer_offline_prepares_style_in_exact(rng, monkeypatch):
    """The style context that infer_offline decodes against is the one
    infer_once uses: prepared in fp32 ("exact") on every rung, also when the
    acoustic model and vocoder run under bf16 autocast ("fast")."""
    p_emf, p_conan, vq, p_voc = [params_from_jax(t, "cpu") for t in _small_params()]
    eng = StreamingVoiceConversion(port_config(SMALL), p_emf, p_conan, vq, p_voc,
                                   serving_precision="fast", device="cpu")
    src = (rng.standard_normal(HOP * 8) * 0.1).astype(np.float32)
    ref = (rng.standard_normal(HOP * 20) * 0.1).astype(np.float32)
    seen = []
    prepare = eng.conan.prepare_style
    monkeypatch.setattr(eng.conan, "prepare_style",
                        lambda *a, **k: seen.append(prepare(*a, **k)) or seen[-1])
    eng.infer_offline(src, ref)
    assert len(seen) == 1
    with torch.inference_mode():
        want = eng._prepare(eng.wav_to_mel(ref))
    assert set(seen[0]) == set(want)
    for k in want:
        torch.testing.assert_close(seen[0][k], want[k], rtol=0, atol=0)


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    dirs = write_random_checkpoints(str(tmp_path), _small_hparams(), seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(*dirs)


def test_precision_scope_sets_and_restores():
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    old = (matmul.allow_tf32, cudnn.allow_tf32)
    cpu = torch.device("cpu")
    with precision_scope("high", cpu):
        assert matmul.allow_tf32 and cudnn.allow_tf32
        with precision_scope("exact", cpu):
            assert not matmul.allow_tf32 and not cudnn.allow_tf32
        assert matmul.allow_tf32 and cudnn.allow_tf32
    with precision_scope("fast", cpu):
        assert (torch.ones(2, 2) @ torch.ones(2, 2)).dtype == torch.bfloat16
    assert (matmul.allow_tf32, cudnn.allow_tf32) == old


class _Recorder:
    """Wraps a parameter tree and records the key path of every tensor read."""

    def __init__(self, tree, seen, path=""):
        self._tree, self._seen, self._path = tree, seen, path

    def _wrap(self, key, value):
        path = f"{self._path}/{key}"
        if torch.is_tensor(value):
            self._seen.add(path)
            return value
        return _Recorder(value, self._seen, path)

    def __getitem__(self, key):
        return self._wrap(key, self._tree[key])

    def get(self, key, default=None):
        return self[key] if key in self._tree else default

    def __contains__(self, key):
        return key in self._tree

    def __iter__(self):
        return (self._wrap(i, v) for i, v in enumerate(self._tree))


def test_r5_deploy_checkpoints_load_into_port():
    """Every leaf of the three deploy checkpoints is read by the port's
    inference path (apart from the VQ's EMA training buffers), none is
    missing, and the deploy Emformer's codes on the first second of
    gt_b0.wav equal the JAX package's."""
    if not all(os.path.isdir(d) for d in DEPLOY.values()):
        pytest.skip("the r5 deploy checkpoints are not in this checkout")
    from conan_tpu.audio.mel import MelConfig, wav2mel_librosa
    from conan_tpu.data.binarizer import load_wav
    from conan_tpu.models.emformer import EmformerConfig as JEmfConfig
    from conan_tpu_torch.config import HParams, load_config
    from conan_tpu_torch.models.conan.model import Conan, ConanConfig
    from conan_tpu_torch.models.emformer import EmformerConfig, EmformerDistillModel
    from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig, HifiGanGenerator

    hp = {k: HParams(load_config(os.path.join(d, "config.yaml"))) for k, d in DEPLOY.items()}
    emf_np = load_ckpt_state(DEPLOY["emf"], "params")
    conan_np = load_ckpt_state(DEPLOY["conan"])
    voc_np = load_ckpt_state(DEPLOY["voc"], "params_g")
    emf = EmformerDistillModel(EmformerConfig.from_hparams(hp["emf"]))
    conan = Conan(ConanConfig.from_hparams(hp["conan"]))
    voc = HifiGanGenerator(HifiGanConfig.from_hparams(hp["voc"]))

    wav = load_wav(os.path.join(REPO, "checkpoints/soak_r5_conan/valid_wavs/gt_b0.wav"),
                   16000)[None, :16000]
    mel = np.asarray(wav2mel_librosa(jnp.asarray(wav), MelConfig()))     # [1, 51, 80]
    mel = np.concatenate([mel, np.repeat(mel[:, -1:], 3, 1)], 1)         # 52 + rc 2
    seen: set = set()
    logits = emf.apply(_Recorder(params_from_jax(emf_np, "cpu"), seen), torch.from_numpy(mel))
    assert seen == leaf_paths(emf_np)
    jax_logits = jax.jit(JEmformer(JEmfConfig.from_hparams(hp["emf"])).apply)(emf_np, mel)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), np.asarray(jax_logits).argmax(-1))

    codes = logits.argmax(-1)[:, :8]
    seen = set()
    p = params_from_jax(conan_np, "cpu")
    mel_out = conan.apply(_Recorder(p["params_g"], seen, "/params_g"), codes,
                          ref=torch.from_numpy(mel[:, :24]),
                          vq_state=_Recorder(p["vq_state"], seen, "/vq_state"))["mel_out"]
    training_buffers = {f"/vq_state/{k}" for k in ("ema_count", "ema_weight", "initialized")}
    assert seen == leaf_paths(conan_np) - training_buffers
    seen = set()
    out = voc.apply(_Recorder(params_from_jax(voc_np, "cpu"), seen), mel_out[:, :4])
    assert seen == leaf_paths(voc_np)
    assert out.shape == (1, 4 * HOP, 1) and torch.isfinite(out).all()


def test_r5_deploy_engine_streams_as_offline_on_cpu():
    """build_engine on the three deploy dirs (the path chip_smoke.py --deploy
    takes) streams 0.64 s of gt_b0.wav against 1 s of gt_b1.wav as it runs
    offline."""
    if not all(os.path.isdir(d) for d in DEPLOY.values()):
        pytest.skip("the r5 deploy checkpoints are not in this checkout")
    import chip_smoke

    eng = build_engine(DEPLOY["conan"], DEPLOY["emf"], DEPLOY["voc"], device="cpu")
    assert eng.serving_precision == "exact" and eng.cfg.conan.hidden_size == 256
    wav_dir = os.path.join(REPO, "checkpoints", "soak_r5_conan", "valid_wavs")
    src = chip_smoke.read_wav(os.path.join(wav_dir, "gt_b0.wav"))[:10240]
    ref = chip_smoke.read_wav(os.path.join(wav_dir, "gt_b1.wav"))[:16000]
    wav, codes = eng.infer_once(src, ref, collect_codes=True)
    wav_off, codes_off = eng.infer_offline(src, ref, collect_codes=True)
    np.testing.assert_array_equal(codes, codes_off)
    np.testing.assert_allclose(wav, wav_off, atol=1e-4)
    assert wav.shape == (1, 33 * HOP) and np.abs(wav).max() > 1e-3


def test_port_imports_neither_jax_nor_conan_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import conan_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(conan_tpu_torch.__path__, 'conan_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'conan_tpu' or m.startswith('conan_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr
