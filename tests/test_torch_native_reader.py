"""The port's native record reader (``conan_tpu_torch/data/_native.py`` over
``data/native/record_reader.cc``, built by g++ at first use into
``build/conan_tpu_torch/``) against its Python reader and the JAX package's
readers, on stores written by either package's ``RecordWriter``; the locked
first-use build (``ops/native.build_locked``) shared with the CUDA library.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from conan_tpu.data.record_store import RecordReader as JRecordReader
from conan_tpu.data.record_store import RecordWriter as JRecordWriter

from conan_tpu_torch.data import _native
from conan_tpu_torch.data.record_store import RecordReader, RecordWriter
from conan_tpu_torch.ops import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _items(n: int = 9) -> list[dict]:
    rng = np.random.default_rng(0)
    return [{"item_name": f"u{i}", "mel": rng.standard_normal((int(rng.integers(1, 60)), 80))
             .astype(np.float32), "hubert": rng.integers(0, 100, 7), "spk_id": i % 3,
             "len": i} for i in range(n)]


def _write(writer_cls, path: str, items: list[dict]) -> None:
    w = writer_cls(path)
    for it in items:
        w.add_item(it)
    w.finalize()


def _same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_native_reader_matches_python_and_jax(tmp_path, writer):
    items = _items()
    path = str(tmp_path / "train")
    _write(RecordWriter if writer == "port" else JRecordWriter, path, items)
    native_r = RecordReader(path)
    python_r = RecordReader(path, use_native=False)
    assert native_r._native is not None and python_r._native is None
    jax_readers = [JRecordReader(path), JRecordReader(path, use_native=False)]
    assert len(native_r) == len(python_r) == len(items)
    for i, it in enumerate(items):
        assert _same(native_r[i], it) and _same(python_r[i], it)
        assert all(_same(r[i], it) for r in jax_readers)
        assert native_r.read_raw(i) == python_r.read_raw(i) == jax_readers[1].read_raw(i)
    order = [4, 0, 8, 4, 2]
    got = native_r.gather(order)
    assert got == python_r.gather(order) == [python_r.read_raw(i) for i in order]
    assert [pickle.loads(b)["item_name"] for b in got] == [f"u{i}" for i in order]
    assert native_r.prefault(order) is None and python_r.prefault(order) is None
    assert _same(native_r[8], items[8])
    reader = _native.NativeReader(path, n_threads=3)
    assert len(reader) == len(items) and _same(reader[5], items[5])
    assert reader.gather([1, 1]) == [python_r.read_raw(1)] * 2
    reader.close()
    for r in (native_r, python_r):
        r.close()


def test_out_of_range_index_raises(tmp_path):
    path = str(tmp_path / "s")
    _write(RecordWriter, path, _items(3))
    for r in (RecordReader(path), RecordReader(path, use_native=False)):
        for bad in (-1, 3, 10):
            with pytest.raises(IndexError):
                r[bad]
            with pytest.raises(IndexError):
                r.read_raw(bad)
            with pytest.raises(IndexError):
                r.gather([0, bad])
            with pytest.raises(IndexError):
                r.prefault([bad])
    reader = _native.NativeReader(path)
    with pytest.raises(IndexError):
        reader.read_raw(3)


def test_empty_store(tmp_path):
    """A split with no items (an empty data file) opens with 0 items."""
    path = str(tmp_path / "empty")
    _write(RecordWriter, path, [])
    assert len(RecordReader(path)) == 0 == len(RecordReader(path, use_native=False))


def test_library_is_built_into_build_dir():
    _native.load()
    assert _native.LIB_PATH.exists()
    assert _native.LIB_PATH.parent == native.BUILD_DIR
    assert native.BUILD_DIR == __import__("pathlib").Path(ROOT) / "build" / "conan_tpu_torch"


def test_failed_build_raises_with_gxx_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCE", bad)
    monkeypatch.setattr(_native, "LIB_PATH", tmp_path / "librecordreader.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on bad.cc"):
        _native.build()
    assert not (tmp_path / "librecordreader.so").exists()


def test_concurrent_first_use_builds_once(tmp_path):
    """Two processes that reach a missing library at once: the lock lets one
    build it, and the other finds it up to date."""
    src = tmp_path / "lib.src"
    src.write_text("x")
    script = textwrap.dedent(f"""
        import sys, time
        from pathlib import Path
        sys.path.insert(0, {ROOT!r})
        from conan_tpu_torch.ops.native import build_locked

        def compile_fn(out):
            time.sleep(1.0)
            out.write_text("built")
            with open({str(tmp_path / "log")!r}, "a") as f:
                f.write("build\\n")
            return "compiler output"

        print(repr(build_locked(Path({str(tmp_path / "lib.out")!r}), [{str(src)!r}], compile_fn)))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = sorted(p.communicate(timeout=60)[0].strip() for p in procs)
    assert all(p.returncode == 0 for p in procs), outs
    assert outs == ["''", "'compiler output'"]
    assert (tmp_path / "log").read_text() == "build\n"
    assert (tmp_path / "lib.out").read_text() == "built"
