"""The port's Conan and Emformer data paths (binarizers, record store,
batching, datasets, loader, ``build_train_iter``, the binarize CLI) and its
training loop on the Conan batches, against the JAX package's, on the CPU.

The corpus: 6 synthesized utterances (harmonics of a gliding F0 with noise,
0.9-2.0 s) of 3 speakers, random content codes, each with its F0 contour as
``*_f0.npy`` (zero in an unvoiced stretch). Both binarizers write their own
store; the port's mels come from its log-mel frontend on the CPU (K1's plain
version), held to JAX's at the frontend's bound, atol 2e-4 / rtol 1e-4
(tests/test_torch_logmel.py); everything else in a record must be equal.
The batching tests read one store from both packages, so their batches must
be equal.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from conan_tpu.data import batching as jbatching
from conan_tpu.data.binarizer import ConanBinarizer as JConanBinarizer
from conan_tpu.data.binarizer import EmformerBinarizer as JEmformerBinarizer
from conan_tpu.data.datasets import ConanDataset as JConanDataset
from conan_tpu.data.datasets import EmformerDataset as JEmformerDataset
from conan_tpu.data.record_store import RecordReader as JRecordReader
from conan_tpu.data.record_store import RecordWriter as JRecordWriter
from conan_tpu.train.checkpoint import load_ckpt_state as jax_load_ckpt_state
from conan_tpu.train.run import build_train_iter as jax_build_train_iter
from conan_tpu.train.tasks import ConanTask as JConanTask

from conan_tpu_torch.checkpoint import tree_leaves, tree_to_numpy
from conan_tpu_torch.data import batching
from conan_tpu_torch.data import run_binarize
from conan_tpu_torch.data.binarizer import ConanBinarizer, EmformerBinarizer, split_items
from conan_tpu_torch.data.datasets import ConanDataset, EmformerDataset
from conan_tpu_torch.data.loader import BatchIterator
from conan_tpu_torch.data.record_store import RecordReader, RecordWriter
from conan_tpu_torch.train.run import build_task, build_train_iter, use_random_ref_after
from conan_tpu_torch.train.trainer import Trainer

from tests.test_train_steps import CONAN_HP
from tests.torch_port_util import leaf_shapes
from tests.torch_port_util import one_torch_thread  # noqa: F401

SR, HOP = 16000, 320
ATOL, RTOL = 2e-4, 1e-4
AUDIO_HP = {"audio_sample_rate": SR, "hop_size": HOP, "fft_size": 1024, "win_size": 1024,
            "audio_num_mel_bins": 80, "fmin": 80, "fmax": 7600,
            "valid_prefixes": ["spk2"], "test_prefixes": []}


def _synth(rng, seconds: float):
    """(wav, F0 per frame in Hz, zero over an unvoiced stretch)."""
    t = np.arange(int(seconds * SR)) / SR
    f0 = 150 + 50 * np.sin(2 * np.pi * rng.uniform(0.3, 0.8) * t)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    wav = 0.1 * sum(np.sin(k * phase) / k for k in range(1, 8))
    wav = (wav + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    f0_frames = f0[::HOP].astype(np.float32)
    f0_frames[10:16] = 0.0
    return wav, f0_frames


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    wav_dir, f0_dir = root / "wavs", root / "wavs_f0"
    wav_dir.mkdir()
    f0_dir.mkdir()
    rng = np.random.default_rng(0)
    items = []
    for spk in range(3):
        for utt in range(2):
            name = f"spk{spk}_{utt}"
            wav, f0 = _synth(rng, rng.uniform(0.9, 2.0))
            wavfile.write(wav_dir / f"{name}.wav", SR, wav)
            np.save(f0_dir / f"{name}_f0.npy", f0)
            codes = rng.integers(0, 100, len(f0) + 3)
            items.append({"item_name": name, "wav_fn": str(wav_dir / f"{name}.wav"),
                          "hubert": " ".join(map(str, codes))})
    processed = root / "processed"
    processed.mkdir()
    (processed / "metadata.json").write_text(json.dumps(items))
    (processed / "spker_set.json").write_text(json.dumps({f"spk{i}": i for i in range(3)}))
    hps = {}
    for side, cls, kw in (("jax", JConanBinarizer, {}), ("port", ConanBinarizer,
                                                          {"device": "cpu"}),
                          ("emf_jax", JEmformerBinarizer, {}),
                          ("emf_port", EmformerBinarizer, {"device": "cpu"})):
        hps[side] = dict(AUDIO_HP, processed_data_dir=str(processed),
                         binary_data_dir=str(root / f"binary_{side}"))
        cls(hps[side], **kw).process()
    return hps


def _assert_stores_match_jax(got_dir: str, want_dir: str):
    """The port's store and JAX's: equal records but for the mels, held to
    the frontend's bound; equal lengths and speaker ids."""
    for prefix, n in (("train", 4), ("valid", 2), ("test", 0)):
        got = RecordReader(os.path.join(got_dir, prefix))
        want = JRecordReader(os.path.join(want_dir, prefix), use_native=False)
        assert len(got) == len(want) == n
        for i in range(n):
            g, w = got[i], want[i]
            assert set(g) == set(w)
            for k in w:
                if k == "mel":
                    np.testing.assert_allclose(g[k], w[k], atol=ATOL, rtol=RTOL)
                else:
                    np.testing.assert_array_equal(g[k], w[k])
            assert g["len"] == g["mel"].shape[0] == len(g["hubert"])
        for side in ("lengths", "spk_ids"):
            np.testing.assert_array_equal(np.load(os.path.join(got_dir, f"{prefix}_{side}.npy")),
                                          np.load(os.path.join(want_dir, f"{prefix}_{side}.npy")))


def test_binarizer_matches_jax(corpus):
    _assert_stores_match_jax(corpus["port"]["binary_data_dir"], corpus["jax"]["binary_data_dir"])
    for prefix in ("train", "valid"):
        store = RecordReader(os.path.join(corpus["port"]["binary_data_dir"], prefix))
        assert all(store[i]["len"] == len(store[i]["f0"]) for i in range(len(store)))
    names = ["p231_1", "p100_2", "p334_x", "p100_3"]
    assert split_items(names, ["p231"], ["p334"]) == (["p100_2", "p100_3"], ["p334_x"],
                                                      ["p231_1"])


def test_emformer_binarizer_matches_jax(corpus, caplog):
    """No f0 key, each record as long as the shorter of its codes and mel,
    and no per-item warning about a missing F0."""
    _assert_stores_match_jax(corpus["emf_port"]["binary_data_dir"],
                             corpus["emf_jax"]["binary_data_dir"])
    store = RecordReader(os.path.join(corpus["emf_port"]["binary_data_dir"], "train"))
    assert all("f0" not in store[i] for i in range(len(store)))
    hp = dict(corpus["emf_port"], binary_data_dir=corpus["emf_port"]["binary_data_dir"] + "2")
    with caplog.at_level("WARNING"):
        EmformerBinarizer(hp, device="cpu").process()
    assert not [r for r in caplog.records if "f0" in r.getMessage()]


def test_run_binarize_cli(corpus, tmp_path):
    """``run_binarize.main`` with binarizer_cls emformer (by the reference's
    class path) and --device cpu writes the store EmformerBinarizer writes."""
    cfg = tmp_path / "emf.yaml"
    cfg.write_text(json.dumps(dict(AUDIO_HP,
                                   binarizer_cls="data_gen.conan_binarizer.EmformerBinarizer",
                                   processed_data_dir=corpus["emf_port"]["processed_data_dir"])))
    out = str(tmp_path / "binary")
    run_binarize.main(["--config", str(cfg), "--hparams", f"binary_data_dir={out}",
                       "--device", "cpu"])
    _assert_stores_match_jax(out, corpus["emf_jax"]["binary_data_dir"])
    assert not os.path.exists(tmp_path / "config.yaml")


def test_binarizer_skips_unreadable_items_but_not_frontend_errors(corpus, tmp_path,
                                                                   monkeypatch):
    """An item whose wav cannot be read is skipped with a warning; an error of
    the log-mel frontend (K1 refusing an input on the card) propagates."""
    import conan_tpu_torch.data.binarizer as binarizer

    processed = tmp_path / "processed"
    processed.mkdir()
    with open(os.path.join(corpus["port"]["processed_data_dir"], "metadata.json")) as f:
        items = json.load(f)[:2]
    items[1] = dict(items[1], wav_fn=str(tmp_path / "missing.wav"))
    (processed / "metadata.json").write_text(json.dumps(items))
    hp = dict(AUDIO_HP, processed_data_dir=str(processed),
              binary_data_dir=str(tmp_path / "binary"))
    ConanBinarizer(hp, device="cpu").process()
    got = RecordReader(os.path.join(hp["binary_data_dir"], "train"))
    assert [got[i]["item_name"] for i in range(len(got))] == [items[0]["item_name"]]

    def refuse(wav, cfg):
        raise ValueError("refused by the frontend")

    monkeypatch.setattr(binarizer, "wav2mel_frontend", refuse)
    with pytest.raises(ValueError, match="refused by the frontend"):
        ConanBinarizer(hp, device="cpu").process()


def test_record_store_round_trips_with_jax(tmp_path):
    items = [{"mel": np.arange(12, dtype=np.float32).reshape(3, 4), "name": "a"},
             {"hubert": np.arange(5), "len": 5}, [1, 2, 3]]
    for writer, reader in ((RecordWriter, JRecordReader), (JRecordWriter, RecordReader)):
        path = str(tmp_path / writer.__module__.split(".")[0])
        w = writer(path)
        for item in items:
            w.add_item(item)
        w.finalize()
        r = reader(path)
        assert len(r) == len(items)
        for i in (2, 0, 1, 0):
            got = r[i]
            if isinstance(got, dict):
                assert set(got) == set(items[i])
                for k in got:
                    np.testing.assert_array_equal(got[k], items[i][k])
            else:
                assert got == items[i]
        with pytest.raises(IndexError):
            r[len(items)]


def test_batching_matches_jax():
    sizes = np.random.default_rng(1).integers(40, 900, 200)
    for seed in (0, 1):
        idx = batching.size_shuffled_indices(sizes, np.random.default_rng(seed))
        np.testing.assert_array_equal(
            idx, jbatching.size_shuffled_indices(sizes, np.random.default_rng(seed)))
        for kw in (dict(max_tokens=3000), dict(max_tokens=5000, max_sentences=7),
                   dict(max_tokens=4000, required_batch_size_multiple=4)):
            assert batching.batch_by_size(idx, lambda i: int(sizes[i]), **kw) == \
                jbatching.batch_by_size(idx, lambda i: int(sizes[i]), **kw)
    for kw in (dict(min_len=64, max_len=3000), dict(min_len=128, max_len=1000, growth=1.5)):
        got, want = batching.BucketLadder(**kw), jbatching.BucketLadder(**kw)
        assert got.lengths == want.lengths
        assert [got.fit(n) for n in (1, 64, 65, 1496, 1497, 5000)] == \
            [want.fit(n) for n in (1, 64, 65, 1496, 1497, 5000)]
    assert 1496 in batching.BucketLadder(64, 3000).lengths
    arrs = [np.arange(5), np.arange(3)]
    np.testing.assert_array_equal(batching.collate_1d(arrs, -1, 8),
                                  jbatching.collate_1d(arrs, -1, 8))
    mats = [np.ones((4, 2)), np.ones((2, 2))]
    np.testing.assert_array_equal(batching.collate_2d(mats, 0.0), jbatching.collate_2d(mats))


def _assert_batches_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_conan_dataset_matches_jax(corpus):
    hp = dict(corpus["jax"], max_frames=3000, max_samples_per_spk=100)
    got_ds = ConanDataset(hp["binary_data_dir"], "train", hp, seed=5)
    want_ds = JConanDataset(hp["binary_data_dir"], "train", hp, seed=5)
    assert got_ds.sizes == want_ds.sizes
    for i in (0, 3, 1, 0, 2):
        got, want = got_ds[i], want_ds[i]
        _assert_batches_equal(got, want)
        assert got["uv"].sum() > 0 and np.all(got["f0"] > 0)    # the gap interpolated
    samples = [got_ds[i] for i in range(len(got_ds))]
    jsamples = [want_ds[i] for i in range(len(want_ds))]
    _assert_batches_equal(got_ds.collate(samples, 112, 104),
                          want_ds.collate(jsamples, 112, 104))
    assert (got_ds.collate(samples, 112)["content"][:, -1] == -1).all()


@pytest.mark.parametrize("target_len", [None, 112, 99])
def test_emformer_dataset_collate_matches_jax(corpus, target_len):
    """Mels padded to ⌈T/seg⌉·seg + rc, codes with -1 to ⌈T/seg⌉·seg, and
    the last rc codes of each sample -1 after the crop; the items' draws of
    a reference keep the generator where JAX's is."""
    hp = dict(corpus["emf_jax"], max_frames=3000)
    got_ds = EmformerDataset(hp["binary_data_dir"], "train", hp, seed=5)
    want_ds = JEmformerDataset(hp["binary_data_dir"], "train", hp, seed=5)
    order = (2, 0, 3, 1, 0)
    samples, jsamples = [got_ds[i] for i in order], [want_ds[i] for i in order]
    for got, want in zip(samples, jsamples):
        _assert_batches_equal(got, want)
    for seg, rc in ((4, 2), (3, 0), (4, 5)):
        got = got_ds.collate(samples, target_len, seg=seg, rc=rc)
        _assert_batches_equal(got, want_ds.collate(jsamples, target_len, seg=seg, rc=rc))
        T = target_len or max(s["mel"].shape[0] for s in samples)
        T_utt = -(-T // seg) * seg
        assert got["mels"].shape == (len(order), T_utt + rc, 80)
        assert got["content"].shape == (len(order), T_utt)
        for s, c in zip(samples, got["content"]):
            n = min(len(s["content"]), T_utt + rc) - rc
            np.testing.assert_array_equal(c[:n], s["content"][:n])
            assert (c[max(n, 0):] == -1).all()


def test_batch_iterator_surfaces_producer_errors():
    class Broken:
        sizes = [3, 4, 5]

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("corrupt record")
            return {"content": np.zeros(self.sizes[i])}

    it = iter(BatchIterator(Broken(), lambda s: {"n": len(s)}, max_tokens=None,
                            max_sentences=1))
    with pytest.raises(RuntimeError, match="producer failed") as e:
        for _ in range(10):
            next(it)
    assert isinstance(e.value.__cause__, KeyError)
    ok = BatchIterator(Broken(), lambda s: {"n": len(s)}, max_tokens=None, max_sentences=3)
    ok.ds.sizes = [3, 4]
    it = iter(ok)
    assert [next(it) for _ in range(3)] == [{"n": 2}] * 3      # endless
    it.close()                    # stops the producer thread


def _conan_hp(corpus) -> dict:
    return dict(CONAN_HP, **corpus["jax"], max_tokens=400, max_sentences=3, max_frames=3000,
                vq_start=0, forcing=1, disc_start_steps=2, random_speaker_steps=2,
                max_updates=3, tb_log_interval=1, seed=11, task_cls="conan",
                train_precision="highest")


def test_build_train_iter_matches_jax(corpus):
    hp = _conan_hp(corpus)
    got_it, want_it = build_train_iter(hp, "conan"), jax_build_train_iter(hp, "conan")
    for _ in range(3):
        got, want = next(got_it), next(want_it)
        _assert_batches_equal(got, want)
        assert got["mels"].shape[1] in batching.BucketLadder(64, 3000).lengths
    got_it.close()
    want_it.close()
    hp = dict(corpus["emf_jax"], max_tokens=400, max_sentences=3, max_frames=3000,
              chunk_size=80, right_context=2)
    got_it, want_it = build_train_iter(hp, "emformer"), jax_build_train_iter(hp, "emformer")
    for _ in range(3):
        got, want = next(got_it), next(want_it)
        _assert_batches_equal(got, want)
        assert got["mels"].shape[1] - 2 in batching.BucketLadder(64, 3000).lengths
    got_it.close()
    want_it.close()
    # the postnet reads Conan's batches, as JAX's does
    hp = _conan_hp(corpus)
    got_it, want_it = build_train_iter(hp, "postnet"), jax_build_train_iter(hp, "postnet")
    for _ in range(2):
        _assert_batches_equal(next(got_it), next(want_it))
    got_it.close()
    want_it.close()


def test_build_train_iter_vocoder_matches_jax(corpus):
    """The vocoder's random crops of max_samples // hop frames, from the
    same seeded generator as JAX's."""
    hp = dict(corpus["jax"], max_samples=8192, max_sentences=3)
    got_it, want_it = build_train_iter(hp, "vocoder"), jax_build_train_iter(hp, "vocoder")
    for _ in range(3):
        got, want = next(got_it), next(want_it)
        _assert_batches_equal(got, want)
        assert got["mels"].shape[1:] == (8192 // HOP, 80)
        assert got["wavs"].shape[1] == got["mels"].shape[1] * HOP
    got_it.close()
    want_it.close()


def test_trainer_fit_conan_writes_metrics_and_checkpoint(corpus, tmp_path):
    """Three steps from build_task and build_train_iter: the k-means hook at
    step 1, the reference flipped at step 2; the checkpoint reads back in the
    JAX package."""
    hp = _conan_hp(corpus)
    task, kind = build_task(hp, device="cpu")
    hooks = []
    task_hook = task.host_hook
    task.host_hook = lambda state, step, batch: hooks.append(step) or task_hook(state, step,
                                                                                batch)
    state = Trainer(task, hp, str(tmp_path), use_random_ref_after=use_random_ref_after(hp, kind)
                    ).fit(build_train_iter(hp, kind))
    assert hooks == [1] and int(state["step"]) == 3
    assert float(state["vq_state"]["initialized"]) == 1.0
    with open(tmp_path / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r[k]) for r in records for k in ("l1", "ssim", "fdiff", "uv",
                                                            "a", "d_r", "total_g"))
    assert all(r["skipped"] == 0.0 for r in records)
    assert records[0]["vq_loss"] == 0.0 and records[1]["vq_loss"] > 0.0
    assert records[2]["a"] != 0.0
    saved = jax_load_ckpt_state(str(tmp_path))
    jtask = JConanTask(hp)
    shapes = jax.eval_shape(jtask.init_state, jax.random.PRNGKey(0))
    for key in ("params_g", "params_d", "vq_state"):
        assert leaf_shapes(saved[key]) == leaf_shapes(shapes[key])
        assert leaf_shapes(saved[key]) == leaf_shapes(tree_to_numpy(state[key]))
        for a, b in zip(tree_leaves(saved[key]), tree_leaves(tree_to_numpy(state[key]))):
            np.testing.assert_array_equal(a, b)
    assert int(saved["step"]) == 3


def test_binarizer_defaults_to_cuda(corpus):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ConanBinarizer(corpus["port"])
