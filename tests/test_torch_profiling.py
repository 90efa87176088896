"""The port's profiling helpers (``conan_tpu_torch/utils/profiling.py``) and
vocoder micro-harness (``conan_tpu_torch/infer/bench_vocoder.py``) against
the JAX package's (``conan_tpu/utils/profiling.py``,
``conan_tpu/infer/bench_vocoder.py``), on the CPU.

``Timer`` and ``LatencyHistogram`` are held to JAX's exactly (the same numpy
arithmetic over the same samples; the clock is one fake clock for both).
The harness: both packages' CLIs on one small vocoder checkpoint print the
same two lines, each consistency check OK (max |diff| under 1e-4, the
harness's own bound); a generator whose step drops its carries makes the
port's check print FAIL and exit 1.
"""

import contextlib
import io
import json
import math
import os
import re

import numpy as np
import pytest
import torch
import yaml

from conan_tpu.infer import bench_vocoder as jbench
from conan_tpu.models.vocoder.hifigan import HifiGanGenerator as JHifiGan
from conan_tpu.utils import profiling as jprof

from conan_tpu_torch.checkpoint import save_checkpoint
from conan_tpu_torch.infer import bench_vocoder
from conan_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from conan_tpu_torch.utils import profiling

from tests.torch_port_util import SMALL, numpy_params
from tests.torch_port_util import one_torch_thread  # noqa: F401


class _Clock:
    """perf_counter from a list of readings, for a module's ``time``."""

    def __init__(self, readings):
        self.readings = iter(readings)

    def perf_counter(self):
        return next(self.readings)


READINGS = [0.0, 0.0125, 1.0, 1.5, 2.0, 2.0009, 3.0, 3.25]


def _timed(module, monkeypatch):
    monkeypatch.setattr(module, "time", _Clock(READINGS))
    module.Timer.reset()
    for name, enable in (("emformer", True), ("vocoder", True), ("skipped", False),
                         ("emformer", True), ("vocoder", True)):
        with module.Timer(name, enable=enable):
            pass
    report = module.Timer.report()
    module.Timer.reset()
    return report


def test_timer_report_matches_jax(monkeypatch):
    got, want = _timed(profiling, monkeypatch), _timed(jprof, monkeypatch)
    assert got == want
    assert set(got) == {"emformer", "vocoder"} and got["emformer"]["count"] == 2
    assert profiling.Timer.report() == {}


@pytest.mark.parametrize("drop_first", [0, 5, 200])
def test_latency_histogram_summary_matches_jax(drop_first):
    """The same samples, recorded and measured, give the same summary; with
    every sample dropped both summarise all of them."""
    samples = list(np.random.default_rng(3).gamma(2.0, 3.0, 57))
    hists = (profiling.LatencyHistogram(), jprof.LatencyHistogram())
    for h in hists:
        for ms in samples:
            h.record(ms)
    got, want = (h.summary(drop_first) for h in hists)
    assert got == want
    assert got["n"] == (57 - drop_first if drop_first < 57 else 57)


def test_latency_histogram_measure_matches_jax(monkeypatch):
    synced = []
    out = []
    for module in (profiling, jprof):
        monkeypatch.setattr(module, "time", _Clock(READINGS))
        h = module.LatencyHistogram()
        for _ in range(4):
            with h.measure(sync_fn=lambda: synced.append(1)):
                pass
        out.append(h.samples)
    assert out[0] == out[1] and len(synced) == 8
    assert out[0][0] == pytest.approx(12.5)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU (``device="cpu"``) the trace holds the host's ops; asking
    for the card without one raises."""
    a = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path), device="cpu") as prof:
        (a @ a).sum()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            with profiling.device_trace(str(tmp_path / "card")):
                pass


def test_sync_of_cpu_tensors_does_nothing():
    profiling.sync({"a": torch.ones(2), "b": [torch.zeros(1), None, 3]})
    profiling.sync(torch.ones(1))


# ---------------------------------------------------------------------------
# bench_vocoder
# ---------------------------------------------------------------------------

LINES = (r"vocoder single-chunk \(4 frames = 80 ms audio\): p50 [0-9.]+ ms, "
         r"mean [0-9.]+ ms, RTF [0-9.]+",
         r"incremental-consistency \(4 vs 8 frame chunks\) max\|diff\| = "
         r"([0-9.e+-]+) \((OK|FAIL)\)")


@pytest.fixture(scope="module")
def vocoder_dir(tmp_path_factory):
    """A small causal shuffle vocoder (32 initial channels) with fan-in scaled
    random weights (the models' own random inits leave a small vocoder's wav
    at its bias DC, which no chunking can change)."""
    d = str(tmp_path_factory.mktemp("vocoder"))
    v = SMALL.vocoder
    hp = {"audio_sample_rate": 16000, "audio_num_mel_bins": v.num_mels,
          "upsample_initial_channel": v.upsample_initial_channel,
          "upsample_rates": list(v.upsample_rates),
          "upsample_kernel_sizes": list(v.upsample_kernel_sizes), "resblock": v.resblock,
          "resblock_kernel_sizes": list(v.resblock_kernel_sizes),
          "resblock_dilation_sizes": [list(x) for x in v.resblock_dilation_sizes],
          "upsample": v.upsample}
    params = numpy_params(JHifiGan(v).init, seed=40)
    save_checkpoint(d, 0, {"params_g": params}, hp)
    with open(os.path.join(d, "config.yaml"), "w") as f:
        yaml.safe_dump(hp, f)
    return d


def _run(main, argv):
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue().strip().splitlines()


def _check_lines(lines):
    assert len(lines) == 2, lines
    assert re.fullmatch(LINES[0], lines[0]), lines[0]
    m = re.fullmatch(LINES[1], lines[1])
    assert m, lines[1]
    return float(m.group(1)), m.group(2)


def test_bench_vocoder_prints_jax_lines(vocoder_dir):
    argv = ["--ckpt_dir", vocoder_dir, "--chunks", "6"]
    code, lines = _run(bench_vocoder.main, argv + ["--device", "cpu"])
    jcode, jlines = _run(jbench.main, argv)
    assert code in (0, None) and jcode in (0, None)
    diff, verdict = _check_lines(lines)
    jdiff, jverdict = _check_lines(jlines)
    assert verdict == jverdict == "OK"
    assert diff < 1e-4 and jdiff < 1e-4 and math.isfinite(diff)


def test_bench_vocoder_fails_on_inconsistent_chunks(vocoder_dir, monkeypatch):
    """A step that forgets its carries: the 4- and 8-frame chunkings then
    differ at every chunk boundary, the check prints FAIL and exits 1."""
    step = HifiGanGenerator.step
    monkeypatch.setattr(HifiGanGenerator, "step",
                        lambda self, params, state, mel: (step(self, params, state, mel)[0],
                                                          state))
    code, lines = _run(bench_vocoder.main,
                       ["--ckpt_dir", vocoder_dir, "--chunks", "6", "--device", "cpu"])
    diff, verdict = _check_lines(lines)
    assert code == 1 and verdict == "FAIL" and diff > 1e-3


def test_bench_vocoder_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_vocoder.main(["--chunks", "6"])
