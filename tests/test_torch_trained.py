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
    """bucket_lengths (run_vc's setting, in both packages) pads the reference
    mel with zero frames. The reference encoders' trained LayerNorm biases
    turn those frames into nonzero rows that the k=31 and k=5 convs of the
    last real frames read, so the style context, and the waveform, move.
    Prints the size of the move on 2 s of gt_b0.wav against 1.5 s of
    gt_b1.wav: the codes do not change (the Emformer does not see the
    reference), the waveform does."""
    if not all(os.path.isdir(d) for d in DEPLOY):
        pytest.skip("the r5 deploy checkpoints are not in this checkout")
    import chip_smoke
    from conan_tpu_torch.infer.build import build_engine

    src = chip_smoke.read_wav(os.path.join(WAVS, "gt_b0.wav"))[:32000]
    ref = chip_smoke.read_wav(os.path.join(WAVS, "gt_b1.wav"))[:24000]
    eng = build_engine(*DEPLOY, serving_precision="exact", device="cpu")
    wav, codes = eng.infer_once(src, ref, collect_codes=True, use_scan=True)
    wav_b, codes_b = eng.infer_once(src, ref, collect_codes=True, use_scan=True,
                                    bucket_lengths=True)
    print(json.dumps({"bucketed_vs_unbucketed": {
        "max_abs": float(np.abs(wav_b - wav).max()), "snr_db": _snr_db(wav_b, wav),
        "code_flips": int((codes_b != codes).sum())}}))
    np.testing.assert_array_equal(codes_b, codes)
    assert np.isfinite(wav_b).all() and np.abs(wav_b - wav).max() > 1e-4
