"""The port's native host runtime (``hvq_tpu_torch.native``) against the
JAX package's (``hvq_tpu.native``): the same generator bytes at the same
seeds and thread counts, record files that read and write across both
packages bit for bit and equal the NumPy memmap read, the C++ self-test
built and run, the host counters, and the port's library built from its
own source into ``hvq_tpu_torch/_build/``, never the JAX package's.
These tests need a C++ compiler (``g++``).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hvq_tpu import native as jnative
from hvq_tpu.utils import formats as jformats
from hvq_tpu_torch import native
from hvq_tpu_torch.utils import formats, generators

ROOT = Path(__file__).resolve().parent.parent


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("n,seed,categories,threads", [(1000, 3, 5, 3), (257, 0, 0, 1),
                                                      (4096, 9, 1, 4)])
def test_generators_give_the_jax_bytes(n, seed, categories, threads):
    assert jnative.available()
    d = native.gen_data(n, seed=seed, categories=categories, threads=threads)
    q = native.gen_queries(n, seed=seed, categories=categories, threads=threads)
    assert d.shape == (n, 102) and q.shape == (n, 104)
    np.testing.assert_array_equal(_bits(d), _bits(jnative.gen_data(
        n, seed=seed, categories=categories, threads=threads)))
    np.testing.assert_array_equal(_bits(q), _bits(jnative.gen_queries(
        n, seed=seed, categories=categories, threads=threads)))
    # write_data.c / write_query.c value ranges
    assert -1 <= d[:, 0].min() and d[:, 0].max() <= 1 and np.abs(d[:, 2:]).max() <= 6
    t = q[:, 0].astype(int)
    assert set(t.tolist()) <= {0, 1, 2, 3}
    assert (q[~np.isin(t, (1, 3)), 1] == -1).all()
    assert (q[np.isin(t, (2, 3)), 3] >= q[np.isin(t, (2, 3)), 2]).all()


def test_records_round_trip_across_both_packages(tmp_path):
    rec = native.gen_data(1234, seed=5, categories=7, threads=2)
    native.write_records(tmp_path / "p.bin", rec)
    jnative.write_records(str(tmp_path / "j.bin"), rec)
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    for path in ("p.bin", "j.bin"):
        got = native.read_records(tmp_path / path, 102, threads=3)
        np.testing.assert_array_equal(_bits(got), _bits(rec))
        np.testing.assert_array_equal(_bits(jnative.read_records(str(tmp_path / path), 102)),
                                      _bits(rec))


def test_formats_read_through_the_native_reader(tmp_path, monkeypatch):
    """``utils.formats`` reads through the native reader once it is built,
    bit for bit the NumPy memmap read and the JAX package's read."""
    ds = generators.generate_dataset(3001, seed=8, categories=11)
    qs = generators.generate_queries(77, seed=9, categories=11)
    formats.write_data_bin(tmp_path / "d.bin", ds)
    formats.write_query_bin(tmp_path / "q.bin", qs)
    calls = []
    read = native.read_records
    monkeypatch.setattr(native, "read_records",
                        lambda *a, **k: calls.append(a[1]) or read(*a, **k))
    got = formats.read_data_bin(tmp_path / "d.bin")
    gq = formats.read_query_bin(tmp_path / "q.bin")
    assert calls == [102, 104]
    mm = np.memmap(tmp_path / "d.bin", dtype=np.float32, mode="r", offset=4)
    np.testing.assert_array_equal(_bits(got.record_matrix()),
                                  _bits(np.asarray(mm).reshape(-1, 102)))
    jd = jformats.read_data_bin(tmp_path / "d.bin")
    for f in ("C", "T", "V"):
        np.testing.assert_array_equal(_bits(getattr(got, f)), _bits(getattr(jd, f)))
    np.testing.assert_array_equal(gq.qtype, qs.qtype)
    np.testing.assert_array_equal(_bits(gq.V), _bits(qs.V))


def test_bad_files_raise(tmp_path):
    rec = native.gen_data(10, seed=1)
    native.write_records(tmp_path / "d.bin", rec)
    raw = (tmp_path / "d.bin").read_bytes()
    (tmp_path / "t.bin").write_bytes(raw[:-8])
    (tmp_path / "h.bin").write_bytes(raw[:2])
    for name in ("t.bin", "h.bin"):
        with pytest.raises(ValueError):
            native.read_records(tmp_path / name, 102)
        with pytest.raises(ValueError):
            formats.read_data_bin(tmp_path / name)
    with pytest.raises(OSError):
        native.read_records(tmp_path / "missing.bin", 102)


def test_without_a_compiler_the_numpy_reader_reads(tmp_path, monkeypatch):
    """No C++ compiler and no built library: ``available()`` says so and
    ``utils.formats`` reads through NumPy; building then raises."""
    ds = generators.generate_dataset(100, seed=2)
    formats.write_data_bin(tmp_path / "d.bin", ds)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "compiler", lambda: None)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "none.so")
    assert not native.available()
    got = formats.read_data_bin(tmp_path / "d.bin")
    np.testing.assert_array_equal(_bits(got.V), _bits(ds.V))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.gen_data(10)


def test_a_failing_compile_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*bad.cpp"):
        native._compile(tmp_path / "build" / "libbad.so", [bad], extra=("-shared",))
    assert not list((tmp_path / "build").glob("*.so"))


def test_self_test_builds_and_runs(tmp_path):
    out = native.self_test(tmp_path / "scratch.bin")
    assert "native self-test OK" in out
    assert not (tmp_path / "scratch.bin").exists()


def test_perf_counters_keep_only_what_the_host_allowed():
    with native.PerfCounters() as pc:
        np.dot(np.ones((200, 200)), np.ones((200, 200)))
    rep = pc.report()
    pc.close()
    assert set(pc.values) <= set(native.PERF_COUNTER_NAMES)
    assert all(v >= 0 for v in pc.values.values())
    assert set(rep) - set(pc.values) <= {"IPC", "GHz"}
    with jnative.PerfCounters() as jpc:
        np.dot(np.ones((200, 200)), np.ones((200, 200)))
    jpc.close()
    assert set(pc.values) == set(jpc.values)


def test_the_port_loads_its_own_library_only(tmp_path):
    """A fresh interpreter that uses the port's native module maps the
    library built in ``hvq_tpu_torch/_build/`` and never the JAX
    package's ``hvq_tpu/native/libhvq_native.so``."""
    code = ("import hvq_tpu_torch.native as n; n.gen_data(10); "
            "print(n.build_info['path']); print(open('/proc/self/maps').read())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    path, maps = out.stdout.split("\n", 1)
    assert Path(path).parent == ROOT / "hvq_tpu_torch" / "_build"
    assert Path(path).name.startswith("libhvq_native_") and path in maps
    assert "hvq_tpu/native/libhvq_native.so" not in maps
    assert "hvq_tpu/" not in open(ROOT / "hvq_tpu_torch" / "native" / "__init__.py").read()
