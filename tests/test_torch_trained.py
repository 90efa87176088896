"""The port on the trained r5 weights against the JAX package, on the CPU.

    python -m pytest -m slow tests/test_torch_trained.py -q -s

Both packages' ``infer_once`` convert ``gt_b0.wav`` with ``gt_b1.wav`` as
reference through the three ``checkpoints/soak_r5_*/deploy`` dirs in
``exact``: the content codes must be equal and the waveforms agree to atol
1e-4, the bound tests/test_streaming_engine.py holds streaming to offline
with (fp32 in both packages, sums in other orders). Then the port's ``high``
and ``fast`` rungs against its own ``exact``: the codes must be equal (the
Emformer runs fp32 on every rung) and the waveform SNR and max abs are
printed beside the JAX package's own ladder on these weights
(tools/SERVING_LADDER.json: high 82.74 dB, fast 44.15 dB). On the CPU the
TF32 flags change nothing, so the port's ``high`` equals its ``exact`` here.
Prints one JSON line of the numbers. Skips where ``checkpoints/`` is absent.
"""

import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = [os.path.join(REPO, "checkpoints", f"soak_r5_{name}", "deploy")
          for name in ("conan", "emf", "voc")]
WAVS = os.path.join(REPO, "checkpoints", "soak_r5_conan", "valid_wavs")
ATOL = 1e-4


def _snr_db(wav, ref):
    rms_e = float(np.sqrt((ref ** 2).mean()))
    rms_d = float(np.sqrt(((wav - ref) ** 2).mean()))
    return float("inf") if rms_d == 0 else 20 * np.log10(rms_e / rms_d)


@pytest.mark.slow
def test_trained_r5_port_matches_jax_and_rungs():
    if not all(os.path.isdir(d) for d in DEPLOY):
        pytest.skip("the r5 deploy checkpoints are not in this checkout")
    from conan_tpu.infer.build import _load_dir_config
    from conan_tpu.infer.build import build_engine as jax_build_engine

    import chip_smoke
    from conan_tpu_torch.infer.build import build_engine

    assert not any(_load_dir_config(d).get("serving_precision") for d in DEPLOY)
    src = chip_smoke.read_wav(os.path.join(WAVS, "gt_b0.wav"))
    ref = chip_smoke.read_wav(os.path.join(WAVS, "gt_b1.wav"))
    jax_wav, jax_codes = jax_build_engine(*DEPLOY, serving_precision="exact").infer_once(
        src, ref, collect_codes=True)
    out = {}
    for rung in ("exact", "high", "fast"):
        eng = build_engine(*DEPLOY, serving_precision=rung, device="cpu")
        out[rung] = eng.infer_once(src, ref, collect_codes=True)
    wav, codes = out["exact"]
    result = {"src_s": len(src) / 16000, "ref_s": len(ref) / 16000,
              "exact_vs_jax": {"max_abs": float(np.abs(wav - jax_wav).max()),
                               "snr_db": _snr_db(wav, jax_wav),
                               "code_flips": int((codes != jax_codes).sum())}}
    for rung in ("high", "fast"):
        w, c = out[rung]
        result[f"{rung}_vs_exact"] = {"max_abs": float(np.abs(w - wav).max()),
                                      "snr_db": _snr_db(w, wav),
                                      "code_flips": int((c != codes).sum())}
    print(json.dumps(result))
    assert wav.shape == jax_wav.shape and np.isfinite(wav).all()
    np.testing.assert_array_equal(codes, jax_codes)
    np.testing.assert_allclose(wav, jax_wav, atol=ATOL)
    for rung in ("high", "fast"):
        np.testing.assert_array_equal(out[rung][1], codes)
        assert np.isfinite(out[rung][0]).all()


@pytest.mark.slow
def test_trained_r5_bucketing_moves_the_output():
    """The fault this test is named for, repaired: bucket_lengths (run_vc's
    setting) used to zero-pad the reference mel, and the reference encoders'
    trained LayerNorm biases turned those frames into rows that the k=31
    and k=5 convs of the last real frames read (SNR 27.94 dB on these
    weights). The port now pads the source alone. On 2 s of gt_b0.wav
    against 1.5 s of gt_b1.wav: the bucketed scan equals the unbucketed one
    (codes equal, atol 1e-5) and JAX's infer_once without bucket_lengths
    (codes equal, atol 1e-4). Prints both differences."""
    if not all(os.path.isdir(d) for d in DEPLOY):
        pytest.skip("the r5 deploy checkpoints are not in this checkout")
    from conan_tpu.infer.build import build_engine as jax_build_engine

    import chip_smoke
    from conan_tpu_torch.infer.build import build_engine

    src = chip_smoke.read_wav(os.path.join(WAVS, "gt_b0.wav"))[:32000]
    ref = chip_smoke.read_wav(os.path.join(WAVS, "gt_b1.wav"))[:24000]
    eng = build_engine(*DEPLOY, serving_precision="exact", device="cpu")
    wav, codes = eng.infer_once(src, ref, collect_codes=True, use_scan=True)
    wav_b, codes_b = eng.infer_once(src, ref, collect_codes=True, use_scan=True,
                                    bucket_lengths=True)
    jax_wav, jax_codes = jax_build_engine(*DEPLOY, serving_precision="exact").infer_once(
        src, ref, collect_codes=True)
    print(json.dumps({"bucketed_vs_unbucketed": {
        "max_abs": float(np.abs(wav_b - wav).max()), "snr_db": _snr_db(wav_b, wav),
        "code_flips": int((codes_b != codes).sum())},
        "bucketed_vs_jax_unbucketed": {"max_abs": float(np.abs(wav_b - jax_wav).max()),
                                       "snr_db": _snr_db(wav_b, jax_wav)}}))
    np.testing.assert_array_equal(codes_b, codes)
    np.testing.assert_allclose(wav_b, wav, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(codes_b, jax_codes)
    np.testing.assert_allclose(wav_b, jax_wav, atol=ATOL)


@pytest.mark.slow
def test_trained_r5_postnet_sample_matches_jax():
    """checkpoints/soak_r5_post/deploy (step 300 of the 20x256 DiffNet)
    read by the port: ConanPostnet.sample (K = 25 Euler steps, no clip) on a
    coarse mel and decoder_inp from numpy, against JAX's on the same noise
    and the same spec_min/spec_max (the config has null: the soak corpus's
    stats are not in the tree, so both sides get -8..1 per bin), plain and
    with classifier-free guidance at 2.0. Mels atol 1e-3 (fp32 over 25
    steps of a 20-layer net, sums in other orders)."""
    post_dir = os.path.join(REPO, "checkpoints", "soak_r5_post", "deploy")
    if not os.path.isdir(post_dir):
        pytest.skip("the r5 postnet deploy checkpoint is not in this checkout")
    import torch

    from conan_tpu.models.conan.postnet import ConanPostnet as JConanPostnet
    from conan_tpu.models.conan.postnet import PostnetConfig as JPostnetConfig

    from conan_tpu_torch.checkpoint import load_ckpt_state, params_from_jax
    from conan_tpu_torch.config import load_config
    from conan_tpu_torch.models.conan.postnet import ConanPostnet, PostnetConfig

    hp = dict(load_config(os.path.join(post_dir, "config.yaml")), spec_min=[-8.0] * 80,
              spec_max=[1.0] * 80)
    params = load_ckpt_state(post_dir, "params")
    jpost = JConanPostnet(JPostnetConfig.from_hparams(hp))
    post = ConanPostnet(PostnetConfig.from_hparams(hp))
    rng = np.random.default_rng(0)
    coarse = (rng.standard_normal((1, 96, 80)) * 0.8 - 4.0).astype(np.float32)
    dec_inp = rng.standard_normal((1, 96, hp["hidden_size"])).astype(np.float32)
    noise = rng.standard_normal((1, 96, 80)).astype(np.float32)
    p = params_from_jax(params, "cpu")
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    result = {}
    for scale in (1.0, 2.0):
        ucond = np.zeros_like(dec_inp) if scale != 1.0 else None
        want = np.asarray(jpost.sample(params, coarse, dec_inp, None, noise=noise,
                                       cfg_scale=scale, ucond_inp=ucond))
        got = post.sample(p, t(coarse), t(dec_inp), t(noise), cfg_scale=scale,
                          ucond_inp=None if ucond is None else t(ucond)).numpy()
        result[f"cfg_{scale}"] = {"max_abs": float(np.abs(got - want).max())}
        np.testing.assert_allclose(got, want, atol=1e-3)
    print(json.dumps({"postnet_sample_vs_jax": result}))


@pytest.mark.slow
def test_trained_r5_conan_step_matches_jax():
    """One ConanTask step from the r5 deploy generator and VQ state (the
    discriminator random, from numpy) on gt_b0.wav and gt_b1.wav, in both
    packages on the CPU in fp32: content codes from the trained Emformer (the
    port's engine), mels from the port's frontend, F0 a flat 150 Hz on the
    frames louder than the utterance's median (there is no pitch tracker in
    the port), at step 150 of the deploy config's schedule (VQ on, forcing
    off, guided attention and discriminator on). Dropout off and crops at
    frame 0 on both sides (tests/torch_port_util.py:jax_conan_step_fns).
    Prints the loss terms' largest relative difference and each tree's worst
    gradient leaf, port against JAX and each against the port's float64
    step. Holds the losses to rtol 1e-4 and the port's leaves to its float64
    step within max(1e-3, 4 x JAX's worst leaf from it), chip_smoke.py's
    rule for the card's step: on trained weights an fp32 step's worst leaf
    is past 1e-3 from another's."""
    if not all(os.path.isdir(d) for d in DEPLOY):
        pytest.skip("the r5 deploy checkpoints are not in this checkout")
    import jax
    import jax.numpy as jnp
    import torch

    from conan_tpu.train.tasks import ConanTask as JConanTask

    import chip_smoke
    from conan_tpu_torch.checkpoint import (load_ckpt_state, params_from_jax, tree_leaves,
                                            tree_map)
    from conan_tpu_torch.config import load_config
    from conan_tpu_torch.infer.build import build_engine
    from conan_tpu_torch.train.tasks import ConanTask
    from tests.torch_port_util import jax_conan_step_fns, numpy_params

    hp = load_config(os.path.join(DEPLOY[0], "config.yaml"))
    hp.update(train_precision="highest")
    step = 150
    assert hp["forcing"] < step < hp["random_speaker_steps"] and step > hp["disc_start_steps"]
    wavs = [chip_smoke.read_wav(os.path.join(WAVS, f"gt_b{i}.wav")) for i in (0, 1)]
    eng = build_engine(*DEPLOY, serving_precision="exact", device="cpu")
    codes = [eng.infer_once(w, wavs[1 - i], collect_codes=True)[1][0]
             for i, w in enumerate(wavs)]
    mels = [eng.wav_to_mel(w)[0].numpy() for w in wavs]
    n = [min(len(c), len(m)) for c, m in zip(codes, mels)]
    T = max(n)
    batch = {"content": np.full((2, T), -1, np.int64), "mels": np.zeros((2, T, 80), np.float32),
             "f0": np.zeros((2, T), np.float32), "uv": np.zeros((2, T), np.float32)}
    for i in range(2):
        energy = mels[i][:n[i]].mean(-1)
        voiced = energy > np.median(energy)
        batch["content"][i, :n[i]] = codes[i][:n[i]]
        batch["mels"][i, :n[i]] = mels[i][:n[i]]
        batch["f0"][i, :n[i]] = np.where(voiced, np.log2(150.0), 0.0)
        batch["uv"][i, :n[i]] = ~voiced
    state_np = load_ckpt_state(DEPLOY[0])
    pg_np = jax.tree.map(np.asarray, state_np["params_g"])
    vq_np = jax.tree.map(np.asarray, state_np["vq_state"])
    assert float(vq_np["initialized"]) == 1.0
    jtask = JConanTask(hp)
    pd_np = numpy_params(jtask.mel_disc.init, 2)
    gen, disc = jax_conan_step_fns(jtask)
    key = jax.random.PRNGKey(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, (gl_j, out_j)), grads_g_j = gen(pg_np, pd_np, vq_np, jbatch, jnp.int32(step), key, None,
                                        False)
    (_, (dl_j, _)), grads_d_j = disc(pd_np, jbatch["mels"],
                                     jax.lax.stop_gradient(out_j["mel_out"]), key)

    task = ConanTask(hp, device="cpu")

    def port_grads(dtype):
        """The port's loss terms and gradients in ``dtype``, as its step
        takes them (oneDNN off, as the CPU side of chip_smoke.py's check)."""
        def to(tree):
            return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                            params_from_jax(tree, "cpu"))

        pg, pd = to(pg_np), to(pd_np)
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in task._batch(batch, False).items()}
        leaves_g = [t.requires_grad_(True) for t in tree_leaves(pg)]
        with torch.backends.mkldnn.flags(enabled=False):
            gtot, gl, out = task._gen_losses(pg, to(pd_np), to(vq_np), b, torch.tensor(step),
                                             None, False)
            grads_g = torch.autograd.grad(gtot, leaves_g)
            leaves_d = [t.requires_grad_(True) for t in tree_leaves(pd)]
            dtot, dl, _ = task._disc_losses(pd, b["mels"], out["mel_out"].detach(), None)
            grads_d = torch.autograd.grad(dtot, leaves_d)
        return {k: float(v.detach()) for k, v in {**gl, **dl}.items()}, {"G": grads_g,
                                                                          "D": grads_d}

    losses, grads = port_grads(torch.float32)
    _, grads_64 = port_grads(torch.float64)
    want = {k: float(v) for k, v in {**gl_j, **dl_j}.items()}
    jax_grads = {"G": jax.tree.leaves(grads_g_j), "D": jax.tree.leaves(grads_d_j)}

    def rel(g, w):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))

    def worst(a, b):
        """Each tree's worst leaf: (relative L2 error, leaf index)."""
        return {t: max((rel(x, y), i) for i, (x, y) in enumerate(zip(a[t], b[t]))) for t in a}

    loss_rel = max(abs(losses[k] - want[k]) / abs(want[k]) for k in want if want[k] != 0)
    port_64, jax_64 = worst(grads, grads_64), worst(jax_grads, grads_64)
    print(json.dumps({"conan_step_frames": n, "losses": losses, "loss_max_rel_diff": loss_rel,
                      "worst_leaf_port_vs_jax": worst(grads, jax_grads),
                      "worst_leaf_from_float64": {"port": port_64, "jax": jax_64}}))
    assert all(losses[k] != 0 for k in ("vq_loss", "gloss", "a"))
    assert loss_rel < 1e-4
    # both fp32 steps against the port's float64 one, chip_smoke.py's rule
    limit = max(1e-3, 4 * max(e for e, _ in jax_64.values()))
    assert max(e for e, _ in port_64.values()) <= limit
