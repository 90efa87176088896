"""One rank of the port's data-parallel tests on the CPU (gloo).

    python tests/torch_dist_worker.py RANK WORLD_SIZE RENDEZVOUS_FILE OUT_DIR MODE

Imports only ``conan_tpu_torch``. The processes join one gloo group
through ``file://RENDEZVOUS_FILE`` (a 60 s timeout on every collective).
With WORLD_SIZE 3, rank 2 runs alone, outside the data-parallel world of
ranks 0 and 1 (a subgroup): the one-rank step on the whole padded batch,
which the tests hold the ranks to. Each case is a task's steps on this
rank's block of a seeded global batch. Modes:
  random   (3 processes) every case in float64 with the random parts on (a
           seeded generator), each state compared in memory with the
           one-rank run's (``compare_with_alone``), then the loader's rows
           of the store the test wrote to OUT_DIR/store, and (ranks only)
           the trainer's rank-0 writes and its resume;
  fixed    every case in fp32 without a generator (dropout off, crops at
           frame 0), from the parameters and draws the test wrote to
           OUT_DIR/inputs.pkl, for the comparison with JAX's sharded step;
  card     the small vocoder step in fp32 on cuda:0 (gloo), for
           tests/test_torch_cuda.py.
Writes OUT_DIR/<mode>_rank<RANK>.pkl (OUT_DIR/<mode>_alone.pkl alone); in
the fixed and card modes only rank 0's leaves the test reads, and a sha256
of every leaf.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# as tests/torch_port_util.py: TensorBoard through its stub, no TensorFlow
sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from conan_tpu_torch.checkpoint import params_from_jax, tree_map, tree_to_numpy  # noqa: E402
from conan_tpu_torch.data.batching import BucketLadder  # noqa: E402
from conan_tpu_torch.data.datasets import ConanDataset  # noqa: E402
from conan_tpu_torch.data.loader import BatchIterator  # noqa: E402
from conan_tpu_torch.data.record_store import RecordWriter  # noqa: E402
from conan_tpu_torch.models.conan.model import Conan, ConanConfig  # noqa: E402
from conan_tpu_torch.parallel import dist  # noqa: E402
from conan_tpu_torch.train.tasks import (ConanTask, EmformerTask, PostnetTask,  # noqa: E402
                                         VocoderTask)
from conan_tpu_torch.train.trainer import Trainer  # noqa: E402

N_RANKS = 2
GEN_SEED = 7

# tests/test_train_steps.py's VOC_HP and CONAN_HP (that module imports JAX)
VOC_HP = {
    "audio_sample_rate": 16000, "hop_size": 320, "fft_size": 1024, "win_size": 1024,
    "num_mels": 80, "upsample_initial_channel": 16,
    "upsample_rates": [8, 5, 4, 2], "upsample_kernel_sizes": [16, 10, 8, 4],
    "resblock": "1", "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3, 5]],
    "upsample": "shuffle", "lambda_mel": 5.0, "lambda_adv": 1.0,
    "use_fm_loss": False, "use_ms_stft": True,
    "stft_loss_param": {"fft_sizes": [512], "hop_sizes": [160], "win_lengths": [512]},
    "mel_loss_param": {"mel_bin": 320, "fft_sizes": [512], "hop_sizes": [160],
                       "win_lengths": [512]},
    "generator_optimizer_params": {"lr": 2e-4},
    "generator_scheduler_params": {"step_size": 600, "gamma": 0.999},
    "discriminator_optimizer_params": {"lr": 2e-4},
    "discriminator_scheduler_params": {"step_size": 600, "gamma": 0.999},
    "generator_grad_norm": 10.0, "discriminator_grad_norm": 1.0,
}
CONAN_HP = {
    "hidden_size": 32, "kernel_size": 3, "audio_num_mel_bins": 80,
    "content_embedding_dim": 102, "silent_token": 57, "style": True, "nVQ": 16,
    "vae_dropout": 0.0, "lambda_commit": 0.25, "f0_gen": "orig",
    "predictor_kernel": 5, "predictor_grad": 1.0, "lambda_f0": 1.0, "lambda_uv": 1.0,
    "dec_dilations": [1], "dec_kernel_size": 5, "dec_post_net_kernel": 3,
    "layers_in_block": 1, "dropout": 0.0, "lr": 5e-4, "scheduler": "warmup",
    "warmup_updates": 4000, "optimizer_adam_beta1": 0.9, "optimizer_adam_beta2": 0.98,
    "weight_decay": 0.0, "clip_grad_norm": 1.0, "disc_lr": 1e-4,
    "disc_win_num": 1, "mel_disc_hidden_size": 8,
    "disc_start_steps": 0, "vq_start": -1, "forcing": 1, "random_speaker_steps": 100000,
    "lambda_mel_adv": 0.05, "mel_losses": "l1:0.5|ssim:0.5",
    "discriminator_scheduler_params": {"step_size": 40000, "gamma": 0.5},
    "discriminator_optimizer_params": {"eps": 1e-6, "weight_decay": 0.0},
}

# the vocoder with the spectrogram discriminator (batch norm, crops over the
# longest item, Dropout2d), feature matching and the STFT loss (spectral
# convergence); 32 frames, so that its 32-frame window fits; one row a rank
VOC = dict(VOC_HP, use_spec_disc=True, use_fm_loss=True, fmin=55, fmax=7600,
           train_precision="highest")
VOC_B, VOC_FRAMES = 2, 32
# the vocoder of tests/test_torch_vocoder_train.py (the STFT loss, no
# spectrogram discriminator or feature matching) at its 8 frames, for the
# comparison with JAX, whose whole step compiles in a minute on the CPU
VOC_PLAIN = dict(VOC_HP, train_precision="highest")
VOC_PLAIN_FRAMES = 8
# Conan with the VQ on from step 2: the k-means hook runs from step 2, the
# discriminator from step 2
CONAN = dict(CONAN_HP, vq_start=1, forcing=3, disc_start_steps=2, random_speaker_steps=5,
             train_precision="highest")
CONAN_B, CONAN_T = 4, 96
# valid frames per row of each step's batch. The hook runs first at step 2
# (the step that turns the VQ on, after which the codebook counts as
# initialized): its rows give rank 0 enough prosody rows for the k-means
# alone and rank 1 too few alone. Before it, the hook is tried on the PROBE
# rows, too few over the whole batch, and must defer on every rank.
CONAN_VALID = {0: [96, 80, 96, 64], 1: [96, 96, 72, 96], 2: [40, 40, 4, 4],
               3: [96, 64, 96, 96]}
CONAN_PROBE = [16, 16, 4, 4]
# for the comparison with JAX: the hook first (the k-means on the initial
# parameters, where both sides' features agree to rounding; after steps whose
# Adam updates differ by rounding the k-means may settle elsewhere), then a
# step with the VQ and the discriminator on
CONAN_FIXED = dict(CONAN, vq_start=-1, disc_start_steps=0)
POST = dict(CONAN_HP, residual_layers=2, residual_channels=8, dilation_cycle_length=2,
            timesteps=1000, K_step=4, flow_loss_type="l1", lr=5e-4, decay_steps=50000,
            spec_min=[-6.0] * 80, spec_max=[0.5] * 80, vq_start=1, forcing=3,
            train_precision="highest")
POST_B, POST_T, POST_TR = 4, 48, 40
EMF = {"emformer_input_dim": 16, "emformer_layers": 2, "chunk_size": 80, "right_context": 2,
       "emformer_output_dim": 10, "lr": 1e-3, "warmup_steps": 2, "warmup_init_lr": 1e-4,
       "lr_decay": 0.9, "decay_interval": 1, "min_lr": 1e-6, "optimizer_adam_beta1": 0.9,
       "optimizer_adam_beta2": 0.98, "weight_decay": 0.0, "clip_grad_norm": 1.0,
       "distillation_temperature": 1.5, "lambda_distillation": 0.7,
       "train_precision": "highest"}
EMF_B, EMF_T = 3, 24          # B = 3: padded to rows [0, 1, 2, 0] on 2 ranks


# ---------------------------------------------------------------- batches
def vocoder_batch(seed: int, frames: int = VOC_FRAMES) -> dict:
    rng = np.random.default_rng(seed)
    return {"mels": rng.standard_normal((VOC_B, frames, 80)).astype(np.float32),
            "wavs": (0.1 * rng.standard_normal((VOC_B, frames * 320))).astype(np.float32)}


def conan_batch(seed: int, valid: list[int], T: int = CONAN_T, T_ref: int | None = None
                ) -> dict:
    rng = np.random.default_rng(seed)
    B = len(valid)
    T_ref = T_ref or T
    batch = {"content": rng.integers(0, 100, (B, T)),
             "mels": (rng.standard_normal((B, T, 80)) * 0.5).astype(np.float32),
             "ref_mels": (rng.standard_normal((B, T_ref, 80)) * 0.5).astype(np.float32),
             "f0": (rng.standard_normal((B, T)) * 0.5 + 7.5).astype(np.float32),
             "uv": (rng.random((B, T)) < 0.25).astype(np.float32)}
    for i, n in enumerate(valid):
        batch["content"][i, n:] = -1
        for k in ("mels", "f0", "uv"):
            batch[k][i, n:] = 0
        batch["ref_mels"][i, min(n, T_ref):] = 0
    return batch


def emformer_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 10, (EMF_B, EMF_T))
    codes[0, EMF_T - 2:] = -1
    codes[1, EMF_T - 7:] = -1
    return {"mels": rng.standard_normal((EMF_B, EMF_T + 2, 16)).astype(np.float32),
            "content": codes}


def frozen_conan(seed: int = 1) -> tuple[dict, dict]:
    """A random Conan (the port's init) and an initialized codebook, numpy."""
    gen = torch.Generator().manual_seed(seed)
    conan = Conan(ConanConfig.from_hparams(POST))
    emb = np.random.default_rng(4).uniform(-1, 1, (POST["nVQ"], POST["hidden_size"]))
    vq = {"embedding": emb.astype(np.float32), "ema_count": np.ones(POST["nVQ"], np.float32),
          "ema_weight": emb.astype(np.float32), "initialized": np.ones((), np.float32)}
    return tree_to_numpy(conan.init(gen)), vq


# ---------------------------------------------------------------- cases
def fewer_discriminators(task):
    """The vocoder's MPD cut to its first period and its MSD to its first two
    scales (the full-rate one and one pooled): the fixed widths of all eight
    take ~70 M parameters, and a float64 step on three processes with all
    of them held ~17 GB."""
    task.mpd.discs = task.mpd.discs[:1]
    task.msd.discs = task.msd.discs[:2]
    return task


def make_task(name: str, world, frozen=None, device: str = "cpu"):
    if name.startswith("vocoder"):
        return fewer_discriminators(VocoderTask(VOC if name == "vocoder" else VOC_PLAIN,
                                                device=device, world=world))
    if name.startswith("conan"):
        return ConanTask(CONAN if name == "conan" else CONAN_FIXED, device=device, world=world)
    if name == "postnet":
        pg, vq = frozen if frozen is not None else frozen_conan()
        return PostnetTask(POST, pg, vq, device=device, world=world)
    return EmformerTask(EMF, device=device, world=world)


def case_batches(name: str) -> list[dict]:
    """The global batch of each step."""
    if name == "vocoder":
        return [vocoder_batch(3)]
    if name == "vocoder_plain":
        return [vocoder_batch(3, VOC_PLAIN_FRAMES)]
    if name == "conan":
        return [conan_batch(10 + s, CONAN_VALID[s]) for s in sorted(CONAN_VALID)]
    if name == "conan_fixed":
        return [conan_batch(12, CONAN_VALID[2])]
    if name == "postnet":
        return [conan_batch(6, [48, 40, 48, 30], POST_T, POST_TR)]
    return [emformer_batch(5), emformer_batch(6)]


def rows(batch: dict, world) -> dict:
    """This rank's block, or alone the whole batch padded as N_RANKS ranks
    pad it."""
    return (dist.pad_batch_to_multiple(batch, N_RANKS) if world is None
            else dist.local_rows(batch, world))


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {p: v for k, x in tree.items() for p, v in _flat(x, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _flat(x, f"{prefix}/{i}").items()}
    return {prefix: None if tree is None else np.asarray(tree)}


def run_case(name: str, world, *, random: bool, state=None, frozen=None,
             draws=None, dtype=torch.float32, n_steps: int | None = None,
             device: str = "cpu", batches: list | None = None) -> dict:
    """The case's steps (the trainer's hook before each, as ``Trainer.fit``
    runs it) → {"state": {path: array}, "metrics": [per step], "hook":
    [(step, done, local nonzero rows)]}, over the first ``n_steps`` of
    ``batches`` (by default the case's). ``state`` (numpy, the JAX tree)
    replaces the task's init; ``draws`` (the postnet's global t and x0)
    replaces its flow draws, cut to this rank's rows."""
    task = make_task(name, world, frozen, device)
    st = task.init_state(torch.Generator().manual_seed(0))
    if state is not None:
        st = dict(st, **params_from_jax(state, device))
        for p, o in (("params_g", "opt_g"), ("params_d", "opt_d"), ("params", "opt")):
            if p in state:
                st[o] = getattr(task, o).init(st[p])
    if dtype == torch.float64:
        st = tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point()
                      else t, st)
    st = dist.broadcast_state(st, world)
    if draws is not None:
        t, x0 = (torch.from_numpy(np.asarray(a)) for a in draws)
        blk = slice(None) if world is None else world.block(t.shape[0] // world.size)
        task.postnet.flow.draws = lambda x1, generator: (t[blk], x0[blk])
    gen = torch.Generator().manual_seed(GEN_SEED) if random else None
    out = {"metrics": [], "hook": []}
    hook_done = not hasattr(task, "host_hook")
    for i, batch in enumerate((batches or case_batches(name))[:n_steps]):
        b = {k: v.astype(np.float64) if v.dtype == np.float32 and dtype == torch.float64
             else v for k, v in rows(batch, world).items()}
        if not hook_done and int(st["step"]) >= task.hp["vq_start"] + 1:
            probe = rows(conan_batch(9, CONAN_PROBE), world)
            for hb in (probe, b):
                hb = {k: v.astype(b["mels"].dtype) if k == "mels" else v for k, v in hb.items()}
                with torch.no_grad():
                    feats = task.model.prosody.pre_vq(st["params_g"]["prosody"],
                                                      torch.from_numpy(hb["mels"]).to(device))
                local = int((feats.abs().sum(-1) > 0).sum())
                new, hook_done = task.host_hook(st, int(st["step"]), hb)
                if new is not None:
                    st = new
                    out["kmeans"] = _flat(tree_to_numpy(st["vq_state"]))
                out["hook"].append((int(st["step"]), bool(hook_done), local))
        st, m = task.train_step(st, b, gen)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["state"] = _flat(tree_to_numpy({k: v for k, v in st.items() if k != "frozen"}))
    return out


def rows_ops(world) -> dict:
    """``dist.roll_rows`` and ``dist.rand``/``randn``/``randint`` under the
    world's scope, of a global batch of 3 rows (padded to 4)."""
    x = torch.arange(3 * 5, dtype=torch.float32).reshape(3, 5)
    x = dist.pad_batch_to_multiple({"x": x}, N_RANKS)["x"]
    if world is not None:
        x = x[world.block(2)]
    gen = torch.Generator().manual_seed(3)
    with dist.scope(world):
        b = x.shape[0]
        return {"roll": dist.roll_rows(x, -1).numpy(),
                "rand": dist.rand((b, 6), gen).numpy(), "randn": dist.randn((b, 2, 3), gen).numpy(),
                "randint": dist.randint(0, 9, (b,), gen).numpy(),
                "scalar": dist.rand((), gen).numpy()}


# ---------------------------------------------------------------- loader, trainer
def write_store(data_dir: str, n: int = 7) -> None:
    """A train split of ``n`` Conan records of 40-90 frames, four speakers."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(11)
    w = RecordWriter(f"{data_dir}/train")
    lengths, spk = [], []
    for i in range(n):
        T = int(rng.integers(40, 90))
        w.add_item({"item_name": f"u{i}", "mel": rng.standard_normal((T, 80)).astype(np.float32),
                    "hubert": rng.integers(0, 100, T), "spk_id": i % 4,
                    "f0": (200 + 50 * rng.random(T)).astype(np.float32), "len": T})
        lengths.append(T)
        spk.append(i % 4)
    w.finalize()
    np.save(f"{data_dir}/train_lengths.npy", np.asarray(lengths))
    np.save(f"{data_dir}/train_spk_ids.npy", np.asarray(spk))


def loader_batches(data_dir: str, world, n: int = 4) -> list[dict]:
    """The first ``n`` batches of a Conan BatchIterator (max_sentences 3, so
    every global batch pads to 4 rows on 2 ranks), collated at the ladder's
    rungs as ``train.run.build_train_iter`` collates them."""
    hp = dict(CONAN, max_frames=3000)
    ds = ConanDataset(data_dir, "train", hp)
    ladder = BucketLadder(min_len=64, max_len=3000)

    def collate(samples, target_len=None, ref_target_len=None):
        if ref_target_len is None:
            ref_target_len = ladder.fit(max(s["ref_mel"].shape[0] for s in samples))
        return ds.collate(samples, target_len, ref_target_len)

    it = iter(BatchIterator(ds, collate, max_tokens=None, max_sentences=3, bucket=ladder,
                            world=world))
    out = []
    for _ in range(n):
        b = next(it)
        out.append({k: b[k] for k in ("content", "mels", "ref_mels", "f0", "uv",
                                      "spk_ids")})
    return out


def trainer_run(work_dir: str, world, max_updates: int) -> dict:
    """``Trainer.fit`` of the Emformer case to ``max_updates`` (a checkpoint
    and a validation every step): → its final state and how often this
    rank's ``valid_fn`` ran."""
    calls = []
    hp = dict(EMF, max_updates=max_updates, val_check_interval=1, tb_log_interval=1,
              num_ckpt_keep=5)
    task = EmformerTask(hp, device="cpu", world=world)
    batches = [rows(b, world) for b in case_batches("emformer") * 3]
    state = Trainer(task, hp, work_dir).fit(iter(batches),
                                            lambda s, step: calls.append(step) or {"v": 1.0})
    return {"state": _flat(tree_to_numpy(state)), "valid_calls": calls}


# ---------------------------------------------------------------- for the tests
def start_ranks(out_dir: str, mode: str, alone: bool = False):
    """Start this script as ranks 0 and 1 of a gloo group meeting in
    ``out_dir`` (with ``alone``, and a third process that runs the one-rank
    step outside their world, all three in one default group for the
    comparison in memory); give the handle to ``collect``."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    ranks = list(range(N_RANKS + (1 if alone else 0)))
    rdv = os.path.join(out_dir, f"rdv_{mode}")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                               str(len(ranks)), rdv, out_dir, mode], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in ranks]
    return out_dir, mode, ranks, procs


def collect(handle, timeout: float = 180.0) -> list[dict]:
    """Wait for the processes (each at most ``timeout`` seconds; a hang is
    killed and fails) → their results, in the order they were started."""
    out_dir, mode, ranks, procs = handle
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p, out in zip(ranks, procs, outs):
        assert p.returncode == 0, f"rank {r} failed (rc {p.returncode}):\n{out[-4000:]}"
    results = []
    for r in ranks:
        with open(os.path.join(out_dir, f"{mode}_{'alone' if r == N_RANKS else f'rank{r}'}.pkl"),
                  "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------- main
def compare_with_alone(state: dict, alone: bool) -> dict | None:
    """In memory, through the default group of all three processes: the
    process running alone broadcasts each leaf of its ``state`` (the path
    list first), and each rank keeps, per leaf, the max abs difference of
    its own from it and a sha256 of its own bytes. Returns that on a rank,
    None alone (the states of the vocoder case take gigabytes in float64,
    so they are not written out)."""
    paths = [p for p in sorted(state) if state[p] is not None]
    got = [paths]
    torch.distributed.broadcast_object_list(got, src=N_RANKS)
    if got[0] != paths:
        raise RuntimeError(f"state paths differ from the one-rank run's: "
                           f"{sorted(set(got[0]) ^ set(paths))}")
    out: dict = {"maxdiff": {}, "hash": {}}
    for p in paths:
        own = np.ascontiguousarray(state[p])
        ref = torch.from_numpy(own.copy())
        torch.distributed.broadcast(ref, src=N_RANKS)
        if not alone:
            out["maxdiff"][p] = float(np.abs(own.astype(np.float64) - ref.numpy()).max()
                                      ) if own.size else 0.0
            out["hash"][p] = leaf_hash(own)
    return None if alone else out


def leaf_hash(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def trimmed(case: dict, keep) -> dict:
    """The case's result with only the state leaves ``keep(path)`` takes, and
    a sha256 of every leaf (the ranks' bit-identity)."""
    state = case["state"]
    return dict(case, state={p: v for p, v in state.items() if keep(p)},
                hash={p: leaf_hash(v) for p, v in state.items() if v is not None})


def main() -> None:
    rank, size, rdv, out_dir, mode = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                      sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    device = "cuda:0" if mode == "card" else "cpu"
    group = dist.init_distributed(device, backend="gloo", init_method=f"file://{rdv}",
                                  rank=rank, world_size=size,
                                  timeout=datetime.timedelta(seconds=60))
    alone = rank == N_RANKS            # the third process: the one-rank run
    world = group
    if size > N_RANKS:
        sub = torch.distributed.new_group(list(range(N_RANKS)),
                                          timeout=datetime.timedelta(seconds=60))
        world = None if alone else dist.World(rank, N_RANKS, group.device, sub)
    result: dict = {}
    if mode == "random":
        for name in ("vocoder", "conan", "postnet", "emformer"):
            case = run_case(name, world, random=True, dtype=torch.float64)
            case["state"] = compare_with_alone(case["state"], alone)
            result[name] = case
        result["loader"] = loader_batches(os.path.join(out_dir, "store"), world)
        result["rows_ops"] = rows_ops(world)
        if world is not None:
            work = os.path.join(out_dir, "trainer")
            result["trainer"] = trainer_run(work, world, 2)
            dist.barrier(world)
            result["trainer_resumed"] = trainer_run(work, world, 3)
    elif mode == "card":
        result["vocoder_plain"] = trimmed(
            run_case("vocoder_plain", world, random=False, device=device),
            lambda p: rank == 0 and "/mu/" in p)
    else:
        with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        for name, kw in inputs.items():
            result[name] = trimmed(run_case(name, world, random=False, **kw),
                                   lambda p: rank == 0 and p.startswith(("/params", "/vq_state")))
    with open(os.path.join(out_dir, f"{mode}_{'alone' if alone else f'rank{rank}'}.pkl"),
              "wb") as f:
        pickle.dump(result, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
