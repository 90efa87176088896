"""The port's batch-conversion runner and what it stands on, against the JAX
package's: ``run_vc.main`` end to end on the CPU, the spectral denoise and
``postprocess``, the config overrides, and ``load_wav``.

Tolerances: the denoise is two fp32 framed DFT products and an overlap-add
in both packages, in other summation orders: 1e-5 on waveforms of peak ~0.5.
Written wavs are int16, so a file equals the engine's output to one step of
1/32767.
"""

import json
import os
from collections.abc import Mapping

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from conan_tpu import config as jconfig
from conan_tpu.audio.denoise import spectral_denoise as jax_spectral_denoise
from conan_tpu.audio.mel import MelConfig as JMelConfig
from conan_tpu.data.binarizer import load_wav as jax_load_wav
from conan_tpu.infer.run_vc import postprocess as jax_postprocess

import conan_tpu_torch.infer.build as port_build
from conan_tpu_torch import config as pconfig
from conan_tpu_torch.audio.denoise import spectral_denoise
from conan_tpu_torch.audio.mel import MelConfig
from conan_tpu_torch.data.binarizer import load_wav
from conan_tpu_torch.infer import run_vc
from conan_tpu_torch.infer.build import build_engine, write_random_checkpoints
from conan_tpu_torch.utils.async_save import AsyncSaver
from tests.torch_port_util import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, HOP = 16000, 320
_MEL = dict(audio_sample_rate=16000, fft_size=1024, hop_size=320, win_size=1024, fmin=80,
            fmax=7600, audio_num_mel_bins=80)


def _hparams(**conan):
    return {
        "conan": dict(_MEL, hidden_size=32, kernel_size=3, silent_token=57, style=True,
                      nVQ=16, f0_gen="orig", predictor_kernel=5, dec_dilations=[1, 1],
                      dec_kernel_size=5, layers_in_block=1, **conan),
        "emformer": dict(emformer_layers=1, chunk_size=80, right_context=2),
        "vocoder": dict(upsample_initial_channel=16, upsample_rates=[8, 5, 4, 2],
                        upsample_kernel_sizes=[16, 10, 8, 4], resblock_kernel_sizes=[3],
                        resblock_dilation_sizes=[[1, 3]]),
    }


def _write(path, wav):
    wavfile.write(path, SR, (np.clip(wav, -1, 1) * 32767).astype(np.int16))


def test_run_vc_main_writes_the_engine_output(tmp_path, rng):
    """Two pairs and one with a missing source: the good pairs are written,
    each equal to the engine's use_scan output after postprocess (with the
    checkpoint's vocoder_denoise_c), and main exits 1 for the bad one."""
    dirs = write_random_checkpoints(str(tmp_path / "ckpt"),
                                    _hparams(vocoder_denoise_c=0.01), seed=0)
    pairs = []
    for i, (n_src, n_ref) in enumerate(((21, 30), (9, 40))):
        src, ref = tmp_path / f"src{i}.wav", tmp_path / f"ref{i}.wav"
        _write(src, rng.standard_normal(HOP * n_src) * 0.1)
        _write(ref, rng.standard_normal(HOP * n_ref) * 0.1)
        pairs.append({"source": str(src), "reference": str(ref),
                      "output": str(tmp_path / "out" / f"vc{i}.wav")})
    pairs.insert(1, {"source": str(tmp_path / "missing.wav"), "reference": pairs[0]["reference"],
                     "output": str(tmp_path / "out" / "never.wav")})
    with open(tmp_path / "pairs.json", "w") as f:
        json.dump(pairs, f)
    argv = ["--pairs", str(tmp_path / "pairs.json"), "--conan_dir", dirs[0],
            "--emformer_dir", dirs[1], "--vocoder_dir", dirs[2], "--device", "cpu"]
    with pytest.raises(SystemExit) as exit_:
        run_vc.main(argv)
    assert exit_.value.code == 1
    assert not os.path.exists(pairs[1]["output"])
    eng = build_engine(*dirs, device="cpu")
    for pair in (pairs[0], pairs[2]):
        want = eng.infer_once(load_wav(pair["source"], SR), load_wav(pair["reference"], SR),
                              use_scan=True, bucket_lengths=True)[0]
        want = run_vc.postprocess(want, eng.cfg.mel, 0.01, device="cpu")
        sr, got = wavfile.read(pair["output"])
        assert sr == SR and got.dtype == np.int16 and got.shape == want.shape
        np.testing.assert_allclose(got / 32767, np.clip(want, -1, 1), atol=1.01 / 32767)


def test_run_vc_precision_and_offline(tmp_path, rng, monkeypatch):
    """--serving_precision left out lets the checkpoint's hparam decide; an
    explicit one wins; --offline writes the offline composition."""
    dirs = write_random_checkpoints(str(tmp_path / "ckpt"),
                                    _hparams(serving_precision="high"), seed=1)
    src, ref, out = tmp_path / "s.wav", tmp_path / "r.wav", tmp_path / "o.wav"
    _write(src, rng.standard_normal(HOP * 10) * 0.1)
    _write(ref, rng.standard_normal(HOP * 12) * 0.1)
    with open(tmp_path / "pairs.json", "w") as f:
        json.dump([{"source": str(src), "reference": str(ref), "output": str(out)}], f)
    rungs = []
    build = port_build.build_engine

    def recording_build(*a, **k):
        eng = build(*a, **k)
        rungs.append(eng.serving_precision)
        return eng

    monkeypatch.setattr(port_build, "build_engine", recording_build)
    argv = ["--pairs", str(tmp_path / "pairs.json"), "--conan_dir", dirs[0],
            "--emformer_dir", dirs[1], "--vocoder_dir", dirs[2], "--device", "cpu"]
    run_vc.main(argv)
    run_vc.main(argv + ["--serving_precision", "exact", "--offline"])
    assert rungs == ["high", "exact"]
    eng = build(*dirs, serving_precision="exact", device="cpu")
    want = eng.infer_offline(load_wav(str(src), SR), load_wav(str(ref), SR),
                             bucket_lengths=True)[0]
    np.testing.assert_allclose(wavfile.read(out)[1] / 32767, np.clip(want, -1, 1),
                               atol=1.01 / 32767)


def test_run_vc_hparams_override_the_checkpoint_config(tmp_path, rng, monkeypatch):
    """--hparams puts dotted overrides on the acoustic checkpoint's config:
    the rung and vocoder_denoise_c come from them."""
    dirs = write_random_checkpoints(str(tmp_path / "ckpt"), _hparams(), seed=2)
    src, ref, out = tmp_path / "s.wav", tmp_path / "r.wav", tmp_path / "o.wav"
    _write(src, rng.standard_normal(HOP * 11) * 0.1)
    _write(ref, rng.standard_normal(HOP * 9) * 0.1)
    with open(tmp_path / "pairs.json", "w") as f:
        json.dump([{"source": str(src), "reference": str(ref), "output": str(out)}], f)
    rungs = []
    build = port_build.build_engine

    def recording_build(*a, **k):
        eng = build(*a, **k)
        rungs.append(eng.serving_precision)
        return eng

    monkeypatch.setattr(port_build, "build_engine", recording_build)
    run_vc.main(["--pairs", str(tmp_path / "pairs.json"), "--conan_dir", dirs[0],
                 "--emformer_dir", dirs[1], "--vocoder_dir", dirs[2], "--device", "cpu",
                 "--hparams", "serving_precision=fast,vocoder_denoise_c=0.02"])
    assert rungs == ["fast"]
    eng = build(*dirs, serving_precision="fast", device="cpu")
    want = eng.infer_once(load_wav(str(src), SR), load_wav(str(ref), SR), use_scan=True,
                          bucket_lengths=True)[0]
    want = run_vc.postprocess(want, eng.cfg.mel, 0.02, device="cpu")
    np.testing.assert_allclose(wavfile.read(out)[1] / 32767, np.clip(want, -1, 1),
                               atol=1.01 / 32767)


@pytest.mark.parametrize("n", [HOP * 50, HOP * 50 + 123, HOP * 70])
def test_denoise_and_postprocess_match_jax(rng, n):
    wav = (rng.standard_normal(n) * 0.2).astype(np.float32)
    wav[: n // 3] *= 0.05                                   # a quiet stretch
    want = np.asarray(jax_spectral_denoise(jnp.asarray(wav[None]), v=0.02, n_fft=1024,
                                           hop=320, win_length=1024))
    got = spectral_denoise(torch.from_numpy(wav[None]), v=0.02, n_fft=1024, hop=320,
                           win_length=1024)
    assert got.shape == want.shape == (1, (n // 320) * 320)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(run_vc.postprocess(wav, MelConfig(), 0.02, device="cpu"),
                               jax_postprocess(wav, JMelConfig(), 0.02), atol=1e-5)
    assert run_vc.postprocess(wav, MelConfig(), 0.0, device="cpu") is wav


def test_postprocess_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    wav = np.zeros(HOP * 64, np.float32)
    for c in (0.02, 0.0):
        with pytest.raises(RuntimeError, match="CUDA"):
            run_vc.postprocess(wav, MelConfig(), c)
    assert run_vc.postprocess(wav, MelConfig(), 0.0, device="cpu") is wav


def test_config_overrides_match_jax():
    cfg = os.path.join(REPO, "egs", "conan_emformer_flow.yaml")
    overrides = "f0_K_step=8,hidden_size=128,dec_dilations=[1,2,4],lr=1e-4,a.b.c=x, flag=true"
    assert pconfig.parse_hparams_overrides(overrides) == \
        jconfig.parse_hparams_overrides(overrides)
    for bad in ("novalue", "a=1,b"):
        with pytest.raises(ValueError):
            pconfig.parse_hparams_overrides(bad)
    want = jconfig.set_hparams(cfg, "", overrides, save=False).to_dict()
    for key in ("work_dir", "exp_name", "infer", "validate"):   # the experiment half
        del want[key]
    got = pconfig.set_hparams(cfg, overrides)
    assert _plain(got) == want
    assert got["f0_gen"] == "flow" and got["f0_K_step"] == 8 and got["a"]["b"]["c"] == "x"
    assert _plain(pconfig.set_hparams(hparams_str="a=1")) == {"a": 1}


def _plain(hp):
    return {k: _plain(v) if isinstance(v, Mapping) else v for k, v in hp.items()}


def test_load_wav_matches_jax(tmp_path, rng):
    x = rng.uniform(-0.9, 0.9, (1234, 2))
    files = {"int16": (x * 32767).astype(np.int16), "int32": (x * 2**31 * 0.99).astype(np.int32),
             "float32": x.astype(np.float32), "float64": x,
             "stereo_int16": (x * 32767).astype(np.int16)}
    for name, data in files.items():
        path = str(tmp_path / f"{name}.wav")
        wavfile.write(path, SR, data if name.startswith("stereo") else data[:, 0])
        got, want = load_wav(path, SR), jax_load_wav(path, SR)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (1234,)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="sample rate"):
        load_wav(path, 22050)


def test_async_saver_runs_and_reports(tmp_path):
    saver = AsyncSaver(workers=2)
    for i in range(5):
        saver.submit((tmp_path / f"{i}.txt").write_text, str(i))
    saver.submit(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        saver.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"{i}.txt" for i in range(5)]
