"""The training CLI's ``--infer`` in the port against the JAX package's, on
the CPU: ``run_test`` (the binarized test split converted chunkwise through
the composed streaming engine, the stream-vs-offline guard,
``infer_manifest.json``) and ``run_test_vocoder`` (copy-synthesis by each
vocoder of the registry).

The split: 4 items of 40-60 frames, two speakers, so that each item's
reference (another item of its speaker) has its own length. Checkpoints:
tests/test_torch_engine.py's small geometry (hidden 32, one Emformer layer,
width-16 vocoder) at ``serving_precision`` exact, with fan-in-scaled weights
(``_signal_weights``): under the models' own random inits a width-16
vocoder's wav is its bias DC, ~1e-7 of it from the mel, and any acoustic
path would pass 1e-4. Each comparison is held against the fault it is there
to catch: the reference padded as JAX's ``run_test`` pads it, another noise
for the flow F0, the mel edge-padded to JAX's 256-frame grid, and another
mel, each move the wav by more than 10 × the tolerance, and another
source mel by more than 100 ×.

Each wav the port writes is held to the JAX engine's chunk steps on the same
item with the reference NOT padded (atol 1e-4, the engine tests' bound):
JAX's ``run_test`` pads the reference to a power of two, which moves the
output wherever the reference encoders' LayerNorm biases are nonzero, so its
own wavs are not the yardstick (ROADMAP.md, JAX-package faults the port does
not carry over). With ``f0_gen: flow`` both sides integrate from JAX's noise
for item i, ``sample_f0_noise(PRNGKey(i), 1, T_pad)``. The vocoder's copy-
synthesis is held to JAX's ``apply`` on the unpadded mel (JAX's
``run_test_vocoder`` pads it to a 256-frame grid, which changes the last
frames of the non-causal generators).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from conan_tpu.infer.build import build_engine as jax_build_engine
from conan_tpu.infer.build import get_vocoder_cls as jax_vocoder_cls
from conan_tpu.models.vocoder.hifigan import HifiGanConfig as JHifiGanConfig
from conan_tpu.train import run as jrun

from conan_tpu_torch.checkpoint import get_last_checkpoint, save_checkpoint
from conan_tpu_torch.data.record_store import RecordWriter
from conan_tpu_torch.infer.build import get_vocoder_cls, write_random_checkpoints
from conan_tpu_torch.infer.streaming import StreamingVoiceConversion
from conan_tpu_torch.models.vocoder.hifigan import HifiGanConfig
from conan_tpu_torch.train import run

from tests.test_torch_engine import _small_hparams
from tests.test_train_steps import VOC_HP
from tests.torch_port_util import one_torch_thread, refill_checkpoint_params  # noqa: F401

LENGTHS, SPEAKERS = (40, 44, 52, 60), (0, 0, 1, 1)
HOP, SR = 320, 16000
ATOL = 1e-4
SENSITIVE = 100 * ATOL      # the least move of a wav under another input
FAULT = 10 * ATOL           # the least move of a wav under each fault the tests hold off


def _signal_weights(dirs, seed: int) -> None:
    """numpy_params' fan-in-scaled draws into each checkpoint's parameters,
    with edits so that the wav depends on everything the tests compare: the
    uv head's bias voices most frames (an unvoiced frame drops the F0, and
    with it the flow's noise); each weight-normed conv of the vocoder gets
    the gain 1 of a fan-in-scaled row (a drawn gain of a one-channel conv can
    be near 0, which cuts the mel off), and the last conv 0.1, which keeps
    the wav in tanh's linear range rather than at ±1."""
    def unit_gains(tree):
        if isinstance(tree, dict):
            if "v" in tree and "g" in tree:
                tree["g"] = np.ones_like(tree["g"])
            for v in tree.values():
                unit_gains(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                unit_gains(v)

    for i, d in enumerate(dirs):
        key = "params" if os.path.basename(d) == "emformer" else "params_g"
        refill_checkpoint_params(d, key, seed + i)
        ckpt, _ = get_last_checkpoint(d)
        p = ckpt["state"][key]
        if "uv_predictor" in p:
            p["uv_predictor"]["out"]["b"][0] = -1.0
        if "conv_post" in p:
            unit_gains(p)
            p["conv_post"]["g"] *= 0.1
        save_checkpoint(d, ckpt["global_step"], ckpt["state"], ckpt["hparams"])


def _write_split(root: str, items: list[dict]) -> str:
    os.makedirs(root, exist_ok=True)
    w = RecordWriter(f"{root}/test")
    for item in items:
        w.add_item(item)
    w.finalize()
    np.save(f"{root}/test_lengths.npy", np.asarray([len(i["mel"]) for i in items]))
    np.save(f"{root}/test_spk_ids.npy", np.asarray([i.get("spk_id", 0) for i in items]))
    return root


def _conan_split(root: str) -> str:
    rng = np.random.default_rng(0)
    return _write_split(root, [
        {"item_name": f"spk{s}_{i}", "spk_id": s,
         "mel": (rng.standard_normal((n, 80)) * 0.5 - 2.0).astype(np.float32),
         "hubert": rng.integers(0, 100, n)} for i, (n, s) in enumerate(zip(LENGTHS, SPEAKERS))])


def _setup(tmp_path, f0_gen: str):
    hparams = _small_hparams()
    hparams["conan"] = {k: v for k, v in hparams["conan"].items() if k != "serving_precision"}
    if f0_gen == "flow":
        hparams["conan"].update(f0_gen="flow", f0_residual_layers=2, f0_residual_channels=8,
                                f0_dilation_cycle_length=2, f0_K_step=4)
    dirs = write_random_checkpoints(str(tmp_path / "ckpt"), hparams, seed=3)
    _signal_weights(dirs, seed=21)
    data = _conan_split(str(tmp_path / "binary"))
    extra = {"binary_data_dir": data, "emformer_ckpt": dirs[1], "vocoder_ckpt": dirs[2],
             "test_consistency_interval": 1}
    return dirs, dict(hparams["conan"], work_dir=dirs[0], **extra), extra


def _capture_wavs(monkeypatch) -> dict:
    """{item name: the float wav} of every wav the port writes (it writes
    int16 files)."""
    wavs = {}
    save = run.save_wav

    def capture(path, wav, sr):
        wavs[os.path.basename(path)[:-4]] = np.asarray(wav)
        save(path, wav, sr)

    monkeypatch.setattr(run, "save_wav", capture)
    return wavs


def _jax_item_wavs(dirs, hp, noises, pad_ref: bool = False, reverse: bool = False) -> dict:
    """The JAX engine's chunk steps on each test item from its binarized
    mels, the source edge-padded to whole chunks plus rc, the reference as
    it is (``pad_ref``: zero-padded to JAX run_test's power-of-two bucket,
    the fault the port does not carry over; ``reverse``: the source mel
    reversed in time, another input)."""
    from conan_tpu.data.datasets import ConanDataset as JConanDataset
    from conan_tpu.config import HParams as JHParams

    jhp = JHParams(dict(hp))
    eng = jax_build_engine(dirs[0], dirs[1], dirs[2], jhp)
    ds = JConanDataset(hp["binary_data_dir"], "test", jhp)
    seg, rc = eng.cfg.seg, eng.cfg.rc
    out = {}
    for i in range(len(ds)):
        s = ds[i]
        T = len(s["content"])
        T_pad = -(-T // seg) * seg
        ref = s["ref_mel"]
        if pad_ref:
            bucket = 64
            while bucket < len(ref):
                bucket *= 2
            ref = np.pad(ref, ((0, bucket - len(ref)), (0, 0)))
        style = eng._prepare(jnp.asarray(ref[None]))
        mel = np.pad(s["mel"][::-1] if reverse else s["mel"], ((0, T_pad - T + rc), (0, 0)),
                     mode="edge")
        state, chunks = eng.init_state(1), []
        for t in range(0, T_pad, seg):
            wav, _, state = eng._step(state, jnp.asarray(mel[None, t:t + seg + rc]), style,
                                      noises[i][:, t:t + seg])
            chunks.append(np.asarray(wav[0, :, 0]))
        out[str(s["item_name"])] = np.concatenate(chunks)[:T * HOP]
    return out


def _keys(manifest: dict):
    return (sorted(manifest), sorted(k for it in manifest["items"] for k in it),
            sorted(k for it in manifest["items"] if it["guard"] for k in it["guard"]))


def test_run_test_cli_matches_jax_engine(tmp_path, monkeypatch):
    """``main --infer`` on a Conan work dir (``f0_gen: orig``, the guard on
    every item): one wav per item, each within 1e-4 of JAX's engine on the
    unpadded reference, and a manifest with JAX's run_test's keys that
    records 4 guarded items."""
    dirs, hp, extra = _setup(tmp_path, "orig")
    wavs = _capture_wavs(monkeypatch)
    overrides = ",".join(f"{k}={v}" for k, v in extra.items())
    run.main(["--exp_name", dirs[0], "--infer", "--hparams", overrides, "--device", "cpu"])
    gen_dir = os.path.join(dirs[0], "generated_last")
    with open(os.path.join(gen_dir, "infer_manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["guard_passed"] and manifest["guard_checked"] == 4
    assert [it["frames"] for it in manifest["items"]] == list(LENGTHS)
    assert all(it["guard"]["ok"] and it["guard"]["max_abs_stream_vs_offline"] <= ATOL
               for it in manifest["items"])
    assert sorted(os.listdir(gen_dir)) == sorted([f"{n}.wav" for n in wavs]
                                                 + ["infer_manifest.json"])
    zeros = {i: jnp.zeros((1, -(-n // 4) * 4, 1)) for i, n in enumerate(LENGTHS)}
    want = _jax_item_wavs(dirs, hp, zeros)
    padded = _jax_item_wavs(dirs, hp, zeros, pad_ref=True)
    reversed_ = _jax_item_wavs(dirs, hp, zeros, reverse=True)
    assert sorted(want) == sorted(wavs)
    for name, w in want.items():
        assert wavs[name].shape == w.shape
        np.testing.assert_allclose(wavs[name], w, atol=ATOL, rtol=0)
        assert np.abs(reversed_[name] - wavs[name]).max() > SENSITIVE, name
        # JAX run_test's padding of the reference would fail this comparison
        assert np.abs(padded[name] - wavs[name]).max() > FAULT, name

    # JAX's own run_test on the same dirs: the manifest's keys
    jdir = tmp_path / "jax_work"
    os.makedirs(jdir)
    for f in os.listdir(dirs[0]):
        if os.path.isfile(os.path.join(dirs[0], f)):
            shutil.copy(os.path.join(dirs[0], f), jdir / f)
    from conan_tpu.config import HParams as JHParams

    jrun.run_test(JHParams(dict(hp, work_dir=str(jdir))))
    with open(jdir / "generated_last" / "infer_manifest.json") as f:
        jmanifest = json.load(f)
    assert _keys(manifest) == _keys(jmanifest)
    assert [it["chunks"] for it in manifest["items"]] == [n // 4 for n in LENGTHS]


def test_run_test_flow_with_jax_noise(tmp_path, monkeypatch):
    """``f0_gen: flow``: each item integrates from JAX's noise for it on both
    sides; the wavs within 1e-4 of JAX's engine, the guard passes."""
    dirs, hp, _ = _setup(tmp_path, "flow")
    jeng = jax_build_engine(*dirs, None)
    noises = {i: jeng.conan.sample_f0_noise(jax.random.PRNGKey(i), 1, -(-n // 4) * 4)
              for i, n in enumerate(LENGTHS)}
    wavs = _capture_wavs(monkeypatch)
    stats = run.run_test(hp, device="cpu",
                         f0_noise_fn=lambda i, T_pad: torch.from_numpy(np.array(noises[i])))
    assert len(stats["wall_s"]) == 4 and stats["capture_ms"] == []    # no graph on the CPU
    want = _jax_item_wavs(dirs, hp, noises)
    rng = np.random.default_rng(5)
    other = _jax_item_wavs(dirs, hp, {i: jnp.asarray(rng.standard_normal(z.shape), jnp.float32)
                                      for i, z in noises.items()})
    for name, w in want.items():
        np.testing.assert_allclose(wavs[name], w, atol=ATOL, rtol=0)
        # another noise for the flow F0 would fail this comparison
        assert np.abs(other[name] - wavs[name]).max() > FAULT, name


def test_run_test_drift_raises_and_records(tmp_path, monkeypatch):
    """Drift past test_consistency_atol on the first guarded item: the
    manifest is written with ``guard_passed: false`` and that item's guard,
    then RuntimeError."""
    _, hp, _ = _setup(tmp_path, "orig")
    offline = StreamingVoiceConversion.offline_mels

    def drifted(self, *a, **k):
        wav, codes = offline(self, *a, **k)
        return wav + 2e-3, codes

    monkeypatch.setattr(StreamingVoiceConversion, "offline_mels", drifted)
    with pytest.raises(RuntimeError, match="drift on item spk0_0"):
        run.run_test(hp, device="cpu")
    with open(os.path.join(hp["work_dir"], "generated_last", "infer_manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["guard_passed"] is False and "guard_checked" not in manifest
    assert len(manifest["items"]) == 1 and not manifest["items"][0]["guard"]["ok"]
    assert manifest["items"][0]["guard"]["max_abs_stream_vs_offline"] > 1e-3


# ---------------------------------------------------------------------------
# run_test_vocoder
# ---------------------------------------------------------------------------

def _vocoder_setup(tmp_path, name: str, **over):
    hp = dict(VOC_HP, vocoder=name, work_dir=str(tmp_path / name),
              binary_data_dir=str(tmp_path / "vbinary"))
    hp = dict(hp, **{"test_consistency_interval": 1, **over})
    rng = np.random.default_rng(1)
    _write_split(hp["binary_data_dir"], [
        {"item_name": f"utt{i}", "mel": rng.standard_normal((n, 80)).astype(np.float32)}
        for i, n in enumerate((22, 33))])
    gen = get_vocoder_cls(name)(HifiGanConfig.from_hparams(hp))
    save_checkpoint(hp["work_dir"], 0, {"params_g": gen.init(torch.Generator().manual_seed(4))})
    _signal_weights([hp["work_dir"]], seed=4)
    with open(os.path.join(hp["work_dir"], "config.yaml"), "w") as f:   # as training saves it
        yaml.safe_dump(dict(hp, task_cls="vocoder"), f)
    return hp, get_last_checkpoint(hp["work_dir"])[0]["state"]["params_g"]


@pytest.mark.parametrize("name", ["HifiGAN", "HifiGAN_noncausal", "HifiGAN_NSF"])
def test_run_test_vocoder_matches_jax(tmp_path, monkeypatch, name):
    """Copy-synthesis of each item, its mel cut to whole chunks of 4
    frames, within 1e-4 of JAX's ``apply`` on that unpadded mel; the causal
    generator's guard (``step`` chunk by chunk against ``apply``) runs on
    every item. Another mel moves the wav by more than 100 × that; JAX's
    edge padding of the mel to a 256-frame grid by more than 10 × for the
    non-causal generators, and for the causal one it changes nothing."""
    hp, params = _vocoder_setup(tmp_path, name, test_consistency_interval=(
        1 if name == "HifiGAN" else 0))
    wavs = _capture_wavs(monkeypatch)
    run.main(["--exp_name", hp["work_dir"], "--infer", "--device", "cpu"])
    jgen = jax_vocoder_cls(name)(JHifiGanConfig.from_hparams(hp))
    apply = jax.jit(jgen.apply)
    mels = np.random.default_rng(1)
    for i, n in enumerate((22, 33)):
        mel = mels.standard_normal((n, 80)).astype(np.float32)
        T = n // 4 * 4
        want = np.asarray(apply(params, jnp.asarray(mel[None, :T])))[0, :T * HOP, 0]
        assert wavs[f"utt{i}"].shape == want.shape
        np.testing.assert_allclose(wavs[f"utt{i}"], want, atol=ATOL, rtol=0)
        other = np.asarray(apply(params, jnp.asarray(mel[None, :T] + 0.5)))[0, :T * HOP, 0]
        assert np.abs(other - wavs[f"utt{i}"]).max() > SENSITIVE
        grid = np.pad(mel[:T], ((0, 256 - T), (0, 0)), mode="edge")
        padded = np.asarray(apply(params, jnp.asarray(grid[None])))[0, :T * HOP, 0]
        if name == "HifiGAN":
            np.testing.assert_allclose(padded, wavs[f"utt{i}"], atol=ATOL, rtol=0)
        else:
            assert np.abs(padded - wavs[f"utt{i}"]).max() > FAULT


@pytest.mark.parametrize("name,over", [("HifiGAN_noncausal", {}), ("HifiGAN_NSF", {}),
                                       ("HifiGAN", {"upsample": "nn"})])
def test_run_test_vocoder_refuses_the_guard_without_a_step(tmp_path, name, over):
    """A generator with no streaming step and the guard on: ValueError naming
    the flag before any item, where JAX's run_test_vocoder fails on item 0
    with AttributeError (or NotImplementedError for "nn")."""
    hp, _ = _vocoder_setup(tmp_path, name, **over)
    with pytest.raises(ValueError, match="test_consistency_interval"):
        run.run_test_vocoder(hp, device="cpu")
    assert not os.path.exists(os.path.join(hp["work_dir"], "generated_test"))


def test_infer_defaults_to_the_card(tmp_path):
    """Without --device cpu both --infer paths run on the CUDA card, and
    raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    _, hp, _ = _setup(tmp_path, "orig")
    with pytest.raises(RuntimeError, match="CUDA"):
        run.run_test(hp)
    hp_voc, _ = _vocoder_setup(tmp_path, "HifiGAN")
    with pytest.raises(RuntimeError, match="CUDA"):
        run.run_test_vocoder(hp_voc)
