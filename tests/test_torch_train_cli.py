"""The port's training entry point against the JAX package's, on the CPU:
``set_hparams`` with the CLI's flags, checkpoint rotation, the trainer's
validation, best checkpoint and resume, the three validation functions,
``train.run.main`` end to end (then ``--validate``), and serving from a
work dir the port's CLI trained.

The corpus: 9 synthesized utterances (1.0-1.6 s) of 3 speakers, random
codes, F0 contours for the Conan items, binarized by the port on the CPU;
spk2 is the valid split. Tolerances: validation metrics rtol 1e-4 (fp32 on
both sides, sums in other orders); a served waveform streaming against
offline atol 1e-4 with equal codes (tests/test_streaming_engine.py).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from conan_tpu import config as jconfig
from conan_tpu.train import run as jrun
from conan_tpu.train.checkpoint import load_ckpt_state as jax_load_ckpt_state
from conan_tpu.train.tasks import ConanTask as JConanTask
from conan_tpu.train.tasks import EmformerTask as JEmformerTask
from conan_tpu.train.tasks import VocoderTask as JVocoderTask

from conan_tpu_torch import config as pconfig
from conan_tpu_torch.checkpoint import get_all_checkpoints, save_checkpoint, tree_to_numpy
from conan_tpu_torch.data import run_binarize
from conan_tpu_torch.data.binarizer import ConanBinarizer
from conan_tpu_torch.infer.build import build_engine, write_random_checkpoints
from conan_tpu_torch.train import run
from conan_tpu_torch.train.optim import AdamW
from conan_tpu_torch.train.tasks import ConanTask, EmformerTask, VocoderTask
from conan_tpu_torch.train.trainer import Trainer

from tests.test_train_steps import CONAN_HP, VOC_HP
from tests.torch_port_util import leaf_shapes
from tests.torch_port_util import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, HOP = 16000, 320
AUDIO_HP = {"audio_sample_rate": SR, "hop_size": HOP, "fft_size": 1024, "win_size": 1024,
            "audio_num_mel_bins": 80, "fmin": 80, "fmax": 7600, "valid_prefixes": ["spk2"],
            "test_prefixes": [], "max_frames": 3000}
# egs/emformer.yaml cut to one layer (width, heads and FFN as shipped)
EMF_OVERRIDES = {"emformer_layers": 1, "lr": 1e-3, "warmup_steps": 2, "max_tokens": 300,
                 "max_sentences": 3, "tb_log_interval": 1, "seed": 3,
                 "train_precision": "highest"}
RTOL = 1e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_corpus")
    wav_dir = root / "wavs"
    os.makedirs(str(wav_dir) + "_f0")
    wav_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    items = []
    for spk in range(3):
        for utt in range(3):
            name = f"spk{spk}_{utt}"
            t = np.arange(int(rng.uniform(1.0, 1.6) * SR)) / SR
            f0 = 150 + 40 * np.sin(2 * np.pi * rng.uniform(0.3, 0.8) * t)
            wav = 0.1 * sum(np.sin(k * 2 * np.pi * np.cumsum(f0) / SR) / k for k in range(1, 8))
            wav = (wav + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
            wavfile.write(wav_dir / f"{name}.wav", SR, wav)
            np.save(f"{wav_dir}_f0/{name}_f0.npy", f0[::HOP].astype(np.float32))
            items.append({"item_name": name, "wav_fn": str(wav_dir / f"{name}.wav"),
                          "hubert": " ".join(map(str, rng.integers(0, 100, len(t) // HOP + 3)))})
    (root / "processed").mkdir()
    (root / "processed" / "metadata.json").write_text(json.dumps(items))
    (root / "processed" / "spker_set.json").write_text(json.dumps({f"spk{i}": i
                                                                  for i in range(3)}))
    hp = dict(AUDIO_HP, processed_data_dir=str(root / "processed"),
              binary_data_dir=str(root / "binary"))
    ConanBinarizer(hp, device="cpu").process()
    return hp


def _plain(hp) -> dict:
    return hp.to_dict() if hasattr(hp, "to_dict") else dict(hp)


def test_set_hparams_matches_jax(tmp_path):
    cfg = os.path.join(REPO, "egs", "soak_r5", "emformer.yaml")
    roots = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}

    def both(argv, **kw):
        got = pconfig.set_hparams(argv=argv, work_dir_root=roots["port"], **kw)
        want = jconfig.set_hparams(argv=argv, work_dir_root=roots["jax"], **kw)
        got, want = _plain(got), _plain(want)
        assert got.pop("work_dir") == os.path.join(roots["port"], "e1")
        assert want.pop("work_dir") == os.path.join(roots["jax"], "e1")
        assert got == want
        saved = {}
        for side in ("port", "jax"):
            with open(os.path.join(roots[side], "e1", "config.yaml")) as f:
                saved[side] = yaml.safe_load(f)
            del saved[side]["work_dir"]
        assert saved["port"] == saved["jax"]
        return got

    first = both(["--config", cfg, "--exp_name", "e1", "--hparams", "lr=1e-3,a.b=[1,2]",
                  "--device", "cpu"])
    assert first["lr"] == 1e-3 and first["emformer_layers"] == 6 and first["a"] == {"b": [1, 2]}
    assert not first["validate"] and not first["infer"]
    # the saved config.yaml is the base now, whatever --config says
    again = both(["--config", os.path.join(REPO, "egs", "soak_r5", "conan.yaml"),
                  "--exp_name", "e1", "--hparams", "max_updates=7", "--validate"])
    assert again["lr"] == 1e-3 and again["max_updates"] == 7 and again["validate"]
    assert again["task_cls"] == "emformer"
    reset = both(["--config", cfg, "--exp_name", "e1", "--reset"])
    assert reset["lr"] == 1e-4 and "a" not in reset
    both(["--exp_name", "e1", "--infer"], save=False)
    assert pconfig.hparams_to_json(pconfig.set_hparams(cfg)) == \
        jconfig.hparams_to_json(jconfig.HParams(pconfig.set_hparams(cfg).to_dict()))
    # an absolute exp_name is the work dir itself
    hp = pconfig.set_hparams(argv=["--exp_name", str(tmp_path / "abs")])
    assert hp["work_dir"] == str(tmp_path / "abs") and (tmp_path / "abs" / "config.yaml").exists()


def test_save_checkpoint_keeps_the_newest():
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        state = {"params": {"w": torch.ones(3)}, "step": torch.tensor(1, dtype=torch.int32)}
        for step in (10, 20, 30, 40, 50):
            save_checkpoint(d, step, state, {"lr": 1.0})
        save_checkpoint(d, 5, state, prefix="model_ckpt_best", num_keep=1)
        save_checkpoint(d, 60, state, num_keep=2)
        assert [os.path.basename(p) for p in get_all_checkpoints(d)] == \
            ["model_ckpt_steps_60.ckpt", "model_ckpt_steps_50.ckpt"]
        assert len(get_all_checkpoints(d, "model_ckpt_best")) == 1
        assert sorted(os.listdir(d)) == ["model_ckpt_best_5.ckpt", "model_ckpt_steps_50.ckpt",
                                         "model_ckpt_steps_60.ckpt"]
        assert jax_load_ckpt_state(d, "params")["w"].tolist() == [1.0, 1.0, 1.0]


def _emf_hp(corpus, work_dir: str, **kw) -> dict:
    hp = jconfig.load_config(os.path.join(REPO, "egs", "emformer.yaml"))
    hp.update(corpus, **EMF_OVERRIDES, work_dir=work_dir)
    hp.update(kw)
    return hp


def _records(work_dir: str) -> list[dict]:
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_validates_saves_best_and_resumes(corpus, tmp_path):
    """tests/test_trainer_integration.py's run on the port: 4 steps with a
    validation and checkpoint every 2, the best kept apart, then a resumed
    run to 6 that starts from step 4 with a sanity validation; the JAX
    package reads the port's checkpoints."""
    work = str(tmp_path / "exp")
    hp = _emf_hp(corpus, work, max_updates=4, val_check_interval=2, num_ckpt_keep=1,
                 save_best=True)
    task, kind = run.build_task(hp, device="cpu")
    state = Trainer(task, hp, work).fit(run.build_train_iter(hp, kind),
                                        run.build_valid_fn(hp, task, kind))
    assert int(state["step"]) == 4
    recs = _records(work)
    assert [r["step"] for r in recs if r["prefix"] == "tr"] == [1, 2, 3, 4]
    vals = [r for r in recs if r["prefix"] == "val"]
    assert [r["step"] for r in vals] == [2, 4]
    assert all(np.isfinite(r[k]) for r in vals for k in ("ce", "acc", "val_loss"))
    assert [os.path.basename(p) for p in get_all_checkpoints(work)] == ["model_ckpt_steps_4.ckpt"]
    best = get_all_checkpoints(work, "model_ckpt_best")
    assert len(best) == 1
    best_step = 2 if vals[0]["val_loss"] <= vals[1]["val_loss"] else 4
    assert best[0].endswith(f"_{best_step}.ckpt")
    assert os.path.exists(os.path.join(work, "codes.zip"))
    assert sorted(os.listdir(os.path.join(work, "valid_codes")))[0].startswith("step2_b0")

    saved = jax_load_ckpt_state(work)
    assert int(saved["step"]) == 4
    want = jax.eval_shape(JEmformerTask(hp).init_state, jax.random.PRNGKey(0))["params"]
    assert leaf_shapes(saved["params"]) == leaf_shapes(want)
    for a, b in zip(jax.tree.leaves(saved["params"]),
                    jax.tree.leaves(tree_to_numpy(state["params"]))):
        np.testing.assert_array_equal(a, b)

    hp2 = dict(hp, max_updates=6, num_sanity_val_steps=1)
    state2 = Trainer(task, hp2, work).fit(run.build_train_iter(hp2, kind),
                                          run.build_valid_fn(hp2, task, kind))
    assert int(state2["step"]) == 6 and int(state2["opt"]["count"]) == 6
    new = _records(work)[len(recs):]
    assert [(r["prefix"], r["step"]) for r in new] == [("sanity", 4), ("tr", 5), ("tr", 6),
                                                       ("val", 6)]
    assert new[0]["val_loss"] == pytest.approx(vals[1]["val_loss"], rel=1e-6)
    assert [os.path.basename(p) for p in get_all_checkpoints(work)] == ["model_ckpt_steps_6.ckpt"]


def _assert_metrics_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=RTOL, abs=1e-6), k


def _batches_equal(got: list, want: list):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in ("mels", "content", "ref_mels", "wavs", "f0", "uv"):
            if k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_emformer_valid_fn_matches_jax(corpus, tmp_path):
    hp = _emf_hp(corpus, str(tmp_path / "port"))
    jhp = jconfig.HParams(dict(hp, work_dir=str(tmp_path / "jax")))
    task, jtask = EmformerTask(hp, device="cpu"), JEmformerTask(jhp)
    got_fn, want_fn = run.build_valid_fn(hp, task, "emformer"), jrun.build_valid_fn(
        jhp, jtask, "emformer")
    _batches_equal(got_fn.batches, want_fn.batches)
    state = task.init_state(torch.Generator().manual_seed(0))
    _assert_metrics_close(got_fn(state, 7), want_fn(tree_to_numpy(state), 7))
    for side in ("port", "jax"):
        assert os.path.exists(tmp_path / side / "valid_codes" / "step7_b0.txt")
    with open(tmp_path / "port" / "valid_codes" / "step7_b0.txt") as f:
        got_txt = f.read()
    with open(tmp_path / "jax" / "valid_codes" / "step7_b0.txt") as f:
        assert got_txt == f.read()


def test_vocoder_valid_fn_matches_jax(corpus):
    hp = dict(corpus, **VOC_HP, max_samples=2560, num_valid_stats=2)
    task, jtask = VocoderTask(hp, device="cpu"), JVocoderTask(jconfig.HParams(hp))
    got_fn, want_fn = run.build_valid_fn(hp, task, "vocoder"), jrun.build_valid_fn(
        jconfig.HParams(hp), jtask, "vocoder")
    _batches_equal(got_fn.batches, want_fn.batches)
    state = task.init_state(torch.Generator().manual_seed(1))
    with torch.backends.mkldnn.flags(enabled=False):
        got = got_fn(state, 0)
    _assert_metrics_close(got, want_fn(tree_to_numpy(state), 0))


def test_conan_valid_fn_matches_jax(corpus, tmp_path):
    """Plots where matplotlib imports; with ``vocoder_ckpt`` naming a
    checkpoint dir, the predicted wav of each plotted batch and the gt wav
    once."""
    voc = write_random_checkpoints(
        str(tmp_path / "ckpt"), {"conan": dict(CONAN_HP), "emformer": {"emformer_layers": 1,
                                                                     "chunk_size": 80,
                                                                     "right_context": 2},
                                 "vocoder": dict(VOC_HP)}, seed=4)[2]
    hp = dict(corpus, **CONAN_HP, num_valid_stats=2, num_valid_plots=1,
              work_dir=str(tmp_path / "port"), vocoder_ckpt=voc)
    jhp = jconfig.HParams(dict(hp, work_dir=str(tmp_path / "jax")))
    task, jtask = ConanTask(hp, device="cpu"), JConanTask(jhp)
    got_fn, want_fn = run.build_valid_fn(hp, task, "conan"), jrun.build_valid_fn(
        jhp, jtask, "conan")
    _batches_equal(got_fn.batches, want_fn.batches)
    state = task.init_state(torch.Generator().manual_seed(2))
    state["vq_state"]["initialized"] = torch.ones(())
    jstate = tree_to_numpy(state)
    _assert_metrics_close(got_fn(state, 0), want_fn(jstate, 0))
    wavs = sorted(os.listdir(tmp_path / "port" / "valid_wavs"))
    assert wavs == sorted(os.listdir(tmp_path / "jax" / "valid_wavs")) == ["gt_b0.wav",
                                                                          "step0_b0_pred.wav"]
    for name in wavs:
        got = wavfile.read(tmp_path / "port" / "valid_wavs" / name)[1].astype(int)
        want = wavfile.read(tmp_path / "jax" / "valid_wavs" / name)[1].astype(int)
        assert np.abs(got - want).max() <= 2                 # int16 steps of 1 / 32767
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    assert os.listdir(tmp_path / "port" / "valid_plots") == ["step0_b0.png"]


def test_build_valid_fn_without_a_valid_split(corpus, tmp_path):
    hp = _emf_hp(dict(corpus, binary_data_dir=str(tmp_path)), str(tmp_path / "w"))
    task, kind = run.build_task(hp, device="cpu")
    assert run.build_valid_fn(hp, task, kind) is None


def _cli_config(corpus, tmp_path) -> str:
    cfg = tmp_path / "emf.yaml"
    cfg.write_text(yaml.safe_dump(dict(base_config=os.path.join(REPO, "egs", "emformer.yaml"),
                                       **corpus)))
    return str(cfg)


def test_main_trains_validates_and_serves(corpus, tmp_path, capsys):
    """``run_binarize.main`` then ``train.run.main`` on --device cpu: a work
    dir with config.yaml, the newest checkpoint alone (num_ckpt_keep 1) and
    val lines; ``--validate`` prints that checkpoint's metrics; the engine
    serves from the work dir (streaming ≡ offline, codes equal)."""
    cfg = _cli_config(dict(corpus, binary_data_dir=str(tmp_path / "binary")), tmp_path)
    run_binarize.main(["--config", cfg, "--device", "cpu"])
    work = str(tmp_path / "exp")
    overrides = ",".join(f"{k}={v}" for k, v in dict(EMF_OVERRIDES, max_updates=3,
                                                      val_check_interval=2,
                                                      num_ckpt_keep=1).items())
    argv = ["--config", cfg, "--exp_name", work, "--hparams", overrides, "--device", "cpu"]
    run.main(argv)
    assert yaml.safe_load(open(os.path.join(work, "config.yaml")))["emformer_layers"] == 1
    assert [os.path.basename(p) for p in get_all_checkpoints(work)] == ["model_ckpt_steps_3.ckpt"]
    recs = _records(work)
    assert [r["step"] for r in recs if r["prefix"] == "val"] == [2]
    assert all(r["skipped"] == 0.0 for r in recs if r["prefix"] == "tr")
    capsys.readouterr()
    run.main(["--exp_name", work, "--validate", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["step"] == 3 and np.isfinite(printed["val_loss"])

    mel = {k: AUDIO_HP[k] for k in ("audio_sample_rate", "hop_size", "fft_size", "win_size",
                                    "audio_num_mel_bins", "fmin", "fmax")}
    conan, _, vocoder = write_random_checkpoints(
        str(tmp_path / "ckpt"), {"conan": dict(CONAN_HP, **mel), "emformer": {
            "emformer_layers": 1, "chunk_size": 80, "right_context": 2},
            "vocoder": dict(VOC_HP)}, seed=5)
    eng = build_engine(conan, work, vocoder, serving_precision="exact", device="cpu")
    assert eng.cfg.emformer.num_layers == 1
    src = wavfile.read(os.path.join(corpus["processed_data_dir"], "..", "wavs",
                                    "spk0_0.wav"))[1][:SR]
    ref = wavfile.read(os.path.join(corpus["processed_data_dir"], "..", "wavs",
                                    "spk1_0.wav"))[1][:SR // 2]
    wav_s, codes_s = eng.infer_once(src, ref, collect_codes=True)
    wav_o, codes_o = eng.infer_offline(src, ref, collect_codes=True)
    np.testing.assert_array_equal(codes_s, codes_o)
    np.testing.assert_allclose(wav_s, wav_o, atol=1e-4)


def test_main_refuses_what_is_not_ported(corpus, tmp_path):
    """--infer and gradient accumulation are ported
    (tests/test_torch_infer_cli.py, tests/test_torch_vocoder_options.py):
    --infer on a work dir with no checkpoint raises FileNotFoundError, the
    Emformer task takes accumulate_grad_batches and ignores it, as JAX's
    does; a train_precision outside the training rungs still raises."""
    cfg = _cli_config(corpus, tmp_path)
    base = ["--config", cfg, "--exp_name", str(tmp_path / "x"), "--device", "cpu"]
    missing = str(tmp_path / "none")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        run.main(base + ["--infer", "--hparams",
                         f"emformer_ckpt={missing},vocoder_ckpt={missing}"])
    hp = pconfig.set_hparams(argv=base + ["--reset", "--hparams", "accumulate_grad_batches=2"],
                             save=False)
    task, kind = run.build_task(hp, device="cpu")
    assert kind == "emformer" and isinstance(task.opt, AdamW) and \
        hp["accumulate_grad_batches"] == 2
    with pytest.raises(ValueError, match="train_precision"):
        run.main(base + ["--reset", "--hparams", "train_precision=fast"])
