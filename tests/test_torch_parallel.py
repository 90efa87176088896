"""The port's data parallelism (``conan_tpu_torch/parallel``) on the CPU: two
gloo ranks against one rank on the padded global batch.

The ranks are subprocesses of ``tests/torch_dist_worker.py`` (which imports
only the port), spawned once for the module together with a third process
that runs the same cases alone and hands its states to the ranks in memory
(the vocoder's take gigabytes in float64); they meet through a ``file://`` rendezvous
in the test's tmp dir, every collective times out after 60 s and every
process after 180 s, so a hang fails the test. The invariant (the JAX step
jitted over a mesh): the step on N ranks, each holding its contiguous block
of the global batch padded by repeating leading rows, is the one-rank step
on that whole padded batch.

Cases (the worker's docstring and constants): the vocoder with the
spectrogram discriminator, feature matching and the STFT loss (B = 2,
32 frames; the MPD's first period and the MSD's first two scales); Conan with the VQ on from step 2 through its k-means hook (B = 4,
four steps, the hook deferring on probe rows first); the postnet on a frozen Conan (B = 4);
the Emformer (B = 3, padded to rows [0, 1, 2, 0]). The random parts are on,
from one seeded generator on every process.

Tolerances: losses rtol 1e-5; parameters, optimizer states and VQ state after
the steps atol 1e-6. The cases run in float64: in fp32 a first Adam update is
-lr · g / (|g| + eps), so an entry whose summed gradient lies within fp32
rounding of zero takes either sign and moves by up to 2·lr (2.6e-5 seen on
the vocoder) whichever way the sum is ordered; float64 leaves the order of
summation below 1e-6 everywhere. The ranks agree bit for bit.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from conan_tpu_torch.parallel import dist
from tests import torch_dist_worker as W

CASES = ("vocoder", "conan", "postnet", "emformer")
# rank 0's TensorBoard directory, where TensorBoard is installed
TB = ["tb"] if importlib.util.find_spec("tensorboard") else []


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist"))
    W.write_store(os.path.join(out, "store"))
    r0, r1, alone = W.collect(W.start_ranks(out, "random", alone=True))
    return {"ranks": (r0, r1), "alone": alone, "dir": out}


def test_pad_batch_and_local_rows():
    """B = 3 on 2 ranks: rows [0, 1, 2, 0], rank 0 holds [0, 1] and rank 1
    [2, 0]; numpy and tensors alike, other entries untouched; alone, the
    batch itself."""
    batch = {"a": np.arange(3), "t": torch.arange(6).reshape(3, 2), "names": ["x", "y", "z"],
             "n": 3}
    padded = dist.pad_batch_to_multiple(batch, 2)
    np.testing.assert_array_equal(padded["a"], [0, 1, 2, 0])
    assert padded["t"][:, 0].tolist() == [0, 2, 4, 0]
    assert padded["names"] == ["x", "y", "z"] and padded["n"] == 3
    for rank, want in ((0, [0, 1]), (1, [2, 0])):
        local = dist.local_rows(batch, dist.World(rank, 2, torch.device("cpu")))
        np.testing.assert_array_equal(local["a"], want)
        assert local["t"][:, 0].tolist() == [2 * w for w in want]
    assert dist.local_rows(batch, None) is batch
    assert dist.pad_batch_to_multiple({"a": np.arange(4)}, 2)["a"].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("name", CASES)
def test_two_rank_step_equals_one_rank(runs, name):
    """Each step's metrics (the global batch's, on every rank) and the state
    after the last step: the two ranks' against the one-rank run on the
    padded global batch, and rank 0's against rank 1's bit for bit."""
    (r0, r1), alone = runs["ranks"], runs["alone"]
    got0, got1, want = r0[name], r1[name], alone[name]
    assert len(got0["metrics"]) == len(want["metrics"]) == len(W.case_batches(name))
    for m0, m1, mw in zip(got0["metrics"], got1["metrics"], want["metrics"]):
        assert set(m0) == set(mw) and m0 == m1
        for k in mw:
            np.testing.assert_allclose(m0[k], mw[k], rtol=1e-5, atol=0, err_msg=f"{name} {k}")
    # each rank's state against the one-rank run's, leaf by leaf, compared
    # in memory by the worker (compare_with_alone)
    assert got0["state"]["maxdiff"] and want["state"] is None
    assert got0["state"]["hash"] == got1["state"]["hash"], f"{name}: the ranks differ"
    for path, d in got0["state"]["maxdiff"].items():
        assert d <= 1e-6, f"{name}{path}: max abs {d} from the one-rank run"
    assert got1["state"]["maxdiff"] == got0["state"]["maxdiff"]
    if name == "conan":     # the VQ moved, and the discriminator stepped
        assert want["metrics"][-1]["vq_loss"] > 0 and want["metrics"][-1]["d_r"] > 0


def test_conan_kmeans_hook_is_global(runs):
    """At step 2 the hook defers on the probe rows and bootstraps on the
    batch, on both ranks as on one, though rank 1's own rows would defer and
    rank 0's alone would not: the decision reads the gathered rows. The
    codebook it leaves equals the one-rank codebook."""
    (r0, r1), alone = runs["ranks"], runs["alone"]
    n_vq = W.CONAN["nVQ"]
    want = alone["conan"]["hook"]
    assert [(s, d) for s, d, _ in want] == [(2, False), (2, True)]
    for r in (r0, r1):
        assert [(s, d) for s, d, _ in r["conan"]["hook"]] == [(s, d) for s, d, _ in want]
    (_, _, n_probe), (_, _, n_batch) = want
    assert n_probe < n_vq <= n_batch
    assert r0["conan"]["hook"][1][2] >= n_vq > r1["conan"]["hook"][1][2]
    for i in (0, 1):
        assert r0["conan"]["hook"][i][2] + r1["conan"]["hook"][i][2] == want[i][2]
    for path, w in alone["conan"]["kmeans"].items():
        assert np.array_equal(r0["conan"]["kmeans"][path], r1["conan"]["kmeans"][path])
        np.testing.assert_allclose(r0["conan"]["kmeans"][path], w, rtol=0, atol=1e-6)
    assert float(alone["conan"]["kmeans"]["/initialized"]) == 1.0


def test_rows_ops(runs):
    """The global roll and the per-row draws under a world: each rank's
    rows of what one rank computes on the padded batch; a scalar draw is one
    draw, the same everywhere."""
    (r0, r1), alone = runs["ranks"], runs["alone"]
    for k in ("roll", "rand", "randn", "randint"):
        np.testing.assert_array_equal(np.concatenate([r0["rows_ops"][k], r1["rows_ops"][k]]),
                                      alone["rows_ops"][k], err_msg=k)
    assert r0["rows_ops"]["scalar"] == r1["rows_ops"]["scalar"] == alone["rows_ops"]["scalar"]
    np.testing.assert_array_equal(alone["rows_ops"]["roll"][:, 0], [5, 10, 0, 0])


def test_loader_gives_each_rank_its_rows(runs):
    """Four Conan batches of at most 3 items: each rank's rows, stacked in
    rank order, are the one-rank batch padded to 4 rows, collated at the
    same rungs on both ranks."""
    (r0, r1), alone = runs["ranks"], runs["alone"]
    assert len(alone["loader"]) == 4
    for b0, b1, bw in zip(r0["loader"], r1["loader"], alone["loader"]):
        want = dist.pad_batch_to_multiple(bw, 2)
        for k, w in want.items():
            assert b0[k].shape == b1[k].shape, k
            np.testing.assert_array_equal(np.concatenate([b0[k], b1[k]]), w, err_msg=k)


def test_trainer_writes_on_rank0_and_resumes_on_both(runs):
    """Trainer.fit on 2 ranks, a validation and a checkpoint every step:
    rank 0 alone validates and writes (one metrics line per step and per
    validation, not two); the run resumed to step 3 starts both ranks from
    the step-2 checkpoint, and their states agree bit for bit."""
    (r0, r1) = runs["ranks"]
    work = os.path.join(runs["dir"], "trainer")
    assert r0["trainer"]["valid_calls"] == [1, 2] and r1["trainer"]["valid_calls"] == []
    assert r0["trainer_resumed"]["valid_calls"] == [3]
    assert r1["trainer_resumed"]["valid_calls"] == []
    with open(os.path.join(work, "metrics.jsonl")) as f:
        lines = [line.split('"prefix": "')[1].split('"')[0] for line in f]
    assert lines == ["tr", "val", "tr", "val", "tr", "val"]
    assert sorted(os.listdir(work)) == sorted(
        ["codes.zip", "metrics.jsonl"] + TB + [f"model_ckpt_steps_{s}.ckpt" for s in (1, 2, 3)])
    for key in ("trainer", "trainer_resumed"):
        s0, s1 = r0[key]["state"], r1[key]["state"]
        assert all(np.array_equal(s0[p], s1[p]) for p in s0)
    assert int(r0["trainer"]["state"]["/step"]) == 2
    assert int(r0["trainer_resumed"]["state"]["/step"]) == 3


def test_training_cli_under_torchrun(tmp_path):
    """``python -m conan_tpu_torch.train.run`` as two ranks with torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
    and ``--device cpu``: the CLI joins a gloo group, each rank reads its
    rows of every global batch, and rank 0 alone writes the config, the
    metrics and the checkpoints."""
    import socket
    import subprocess
    import sys

    import yaml

    data = str(tmp_path / "data")
    W.write_store(data)
    cfg = dict(W.EMF, task_cls="emformer", emformer_input_dim=80, emformer_output_dim=100,
               binary_data_dir=data,
               max_updates=2, val_check_interval=2, tb_log_interval=1, max_sentences=3,
               max_tokens=100000, max_frames=3000, num_sanity_val_steps=0)
    with open(tmp_path / "emf.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    work = str(tmp_path / "work")
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "conan_tpu_torch.train.run", "--config",
             str(tmp_path / "emf.yaml"), "--exp_name", work, "--device", "cpu"],
            cwd=W.ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "rank 1 of 2" in outs[1] and "rank 0 of 2" in outs[0]
    with open(os.path.join(work, "metrics.jsonl")) as f:
        assert [line.count('"prefix": "tr"') for line in f] == [1, 1]
    assert sorted(os.listdir(work)) == sorted(["codes.zip", "config.yaml", "metrics.jsonl",
                                               "model_ckpt_steps_2.ckpt"] + TB)


@pytest.mark.parametrize("name", ["vocoder_plain", "conan_fixed", "emformer"])
def test_world_of_one_rank_steps_as_alone(tmp_path, name):
    """A gloo group of one rank in this process: the task's step through it
    (the gradient all-reduce, the metrics' reduce, the state broadcast) equals
    the step with no world bit for bit, from a state whose keys are not in
    sorted order (the clip norm sums the leaves in the tree's order)."""
    import datetime

    from conan_tpu_torch.checkpoint import tree_leaves

    world = dist.init_distributed("cpu", backend="gloo", init_method=f"file://{tmp_path}/rdv",
                                  rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        task, task_w = W.make_task(name, None), W.make_task(name, world)
        state0 = task.init_state(torch.Generator().manual_seed(0))
        assert list(state0) != sorted(state0)
        batch = W.case_batches(name)[0]
        new, m = task.train_step(state0, batch)
        new_w, m_w = task_w.train_step(dist.broadcast_state(state0, None), batch)
    finally:
        dist.shutdown(world)
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m_w.items()}
    a, b = tree_leaves(dist.sorted_keys(new)), tree_leaves(dist.sorted_keys(new_w))
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)


@pytest.mark.parametrize("n_batches, replicas", [(7, 2), (8, 2), (5, 3), (4, 1)])
def test_shard_for_replicas_matches_jax(n_batches, replicas):
    """``batching.shard_for_replicas`` against the JAX package's, for every
    rank and for the padded list."""
    from conan_tpu.data.batching import shard_for_replicas as jax_shard

    from conan_tpu_torch.data.batching import shard_for_replicas

    batches = [[i, i + 100] for i in range(n_batches)]
    for rank in [None, *range(replicas)]:
        assert shard_for_replicas(batches, replicas, rank) == jax_shard(batches, replicas, rank)
    assert shard_for_replicas(batches, 2, None)[:n_batches] == batches
