"""The port's benchmark runner (``hvq_tpu_torch.tools.bench``) against the
repository's ``bench.py``: the overlapped oracle's resume, the check
fields, the data, the full diff's partner table, and whole CPU runs.

The root script is imported as a module (its ``attempt()`` imports jax
only when called); the port's runner never imports it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench as jbench  # noqa: E402
from hvq_tpu.models.oracle import search_oracle  # noqa: E402
from hvq_tpu.utils.generators import generate_dataset, generate_queries  # noqa: E402

from hvq_tpu_torch.tools import bench  # noqa: E402
from hvq_tpu_torch.utils import generators as tgen  # noqa: E402
from hvq_tpu_torch.utils.formats import slice_queries  # noqa: E402

# The JAX record's keys (bench.py:559-580, :532-539, :583, :620) and the port's.
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_qps", "wall_s", "engine",
            "scan_impl", "timed_runs", "run_qps", "search_phases_ms", "checked_queries",
            "recall_at_100", "dist_check", "max_dist_diff", "full_diff", "full_diff_max",
            "full_diff_queries", "full_diff_engines"}


def test_oracle_thread_resumes_without_duplicating():
    """tests/test_bench_oracle.py's case on the port's OracleThread: the
    second run() resumes at the rows it holds."""
    ds = tgen.generate_dataset(2000, seed=0, categories=30)
    qs = tgen.generate_queries(6, seed=1, categories=30)
    o = bench.OracleThread(ds, qs, 3)
    o.check_n = 1
    o.run()
    assert len(o.oids) == 1
    o.check_n = 3
    o.run()
    assert len(o.oids) == 3
    for i in range(3):
        oid, od = search_oracle(ds, slice_queries(qs, i, i + 1))
        np.testing.assert_array_equal(o.oids[i], oid[0])
        np.testing.assert_allclose(o.odists[i], od[0])


def test_check_fields_alignment():
    ds = tgen.generate_dataset(2000, seed=2, categories=30)
    qs = tgen.generate_queries(4, seed=3, categories=30)
    o = bench.OracleThread(ds, qs, 2)
    o.run()
    oids, odists = search_oracle(ds, qs)
    fields = bench._check_fields(ds, qs, oids, odists, o)
    assert fields["checked_queries"] == 2
    assert fields["recall_at_100"] == 1.0
    assert fields["dist_check"] in ("same", "similar")


@pytest.mark.parametrize("with_dists", [True, False])
def test_check_fields_equal_the_jax_runners(with_dists):
    """On the same ids (a perturbed oracle answer: some rows swapped for
    worse ones) and the same oracle rows, the port's fields are the root
    script's, with the dists given and recomputed."""
    ds = generate_dataset(3000, seed=4, categories=20)
    qs = generate_queries(10, seed=5, categories=20)
    oids, odists = search_oracle(ds, qs)
    ids = oids.copy()
    ids[1, 90:] = ids[1, :10] + 1
    ids[3, 50] = ids[3, 99]
    dists = odists if with_dists else None
    jo, to = jbench.OracleThread(ds, qs, 8), bench.OracleThread(ds, qs, 8)
    jo.oids, jo.odists = list(oids[:8]), list(odists[:8])
    to.oids, to.odists = list(oids[:8]), list(odists[:8])
    want = jbench._check_fields(ds, qs, ids, dists, jo)
    got = bench._check_fields(ds, qs, ids, dists, to)
    assert got == want
    assert got["recall_at_100"] < 1.0


def test_load_or_generate_is_the_root_scripts_bit_for_bit(monkeypatch):
    monkeypatch.setenv("HVQ_BENCH_CACHE", "")
    args = (3000, 50, 30, None, (0, 1, 2, 3))
    jds, jqs = jbench.load_or_generate(*args)
    tds, tqs = bench.load_or_generate(*args)
    for a, b in ((jds, tds), (jqs, tqs)):
        for f in ("C", "T", "V") if a is jds else ("qtype", "v", "l", "r", "V"):
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and np.array_equal(x.view(np.uint8), y.view(np.uint8)), f
    assert bench._cache_key(*args) == jbench._cache_key(*args)


def test_load_or_generate_reads_the_cache_it_writes(monkeypatch, tmp_path):
    """The cache's layout is the root script's: an entry the port writes
    is read back by both runners, memory-mapped, bit for bit."""
    monkeypatch.setenv("HVQ_BENCH_CACHE", str(tmp_path))
    args = (2000, 20, 30, None, (0, 1, 2, 3))
    ds, qs = bench.load_or_generate(*args)
    assert (tmp_path / bench._cache_key(*args) / "ok").exists()
    for runner in (bench, jbench):
        ds2, qs2 = runner.load_or_generate(*args)
        assert isinstance(ds2.V, np.memmap)
        np.testing.assert_array_equal(ds2.V, ds.V)
        np.testing.assert_array_equal(qs2.l, qs.l)


def test_the_dataset_cache_is_off_unless_named(monkeypatch, tmp_path):
    """No default directory: without ``HVQ_BENCH_CACHE`` nothing is written
    and no perm or oracle file is named."""
    monkeypatch.delenv("HVQ_BENCH_CACHE", raising=False)
    monkeypatch.chdir(tmp_path)
    assert bench._cache_dir() is None and bench._cache_path("oracle.npz") is None
    bench.load_or_generate(1000, 10, 30, None, (0, 1, 2, 3))
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("name", bench.EXACT_ENGINES)
def test_full_diff_partner_is_never_the_engine_itself(name):
    for free in (None, 10**15, 10**6):
        partner, why = bench.full_diff_partner(name, 10**7, free)
        assert partner != name
        assert (partner is None) == (why is not None) == (name == "paged" and free == 10**6)
    assert bench.full_diff_partner(name, 10**7, None)[0] == (
        "partitioned" if name == "batched" else "batched")


@pytest.mark.parametrize("name,roomy,tight", [
    ("batched", "partitioned", "paged"),
    ("partitioned", "batched", "paged"),
    ("sharded", "batched", "paged"),
    ("paged", "batched", None),
])
def test_fit_line_moves_with_the_cards_free_memory(monkeypatch, name, roomy, tight):
    """The fit line reads ``torch.cuda.mem_get_info`` (after the primary
    was freed) against the partner's bytes a row, for every partner."""
    n = 10**7
    need = n * bench.PARTNER_BYTES_PER_ROW[roomy]
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    card = torch.device("cuda", 0)
    for free, want in ((need, roomy), (need - 1, tight)):
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None, f=free: (f, 8 * 10**10))
        assert bench.full_diff_partner(name, n, bench.free_bytes(card))[0] == want
    assert bench.free_bytes(torch.device("cpu")) is None


def test_partner_keywords_drop_the_plane_and_keep_what_the_partner_takes():
    kw = bench.partner_kwargs("batched", dict(scan_store="bf16", time_view_max_bytes=0,
                                              route_buckets=(4096,), kprime=200), "cpu")
    assert kw == dict(kprime=200, device="cpu")


def test_engine_keywords_follow_the_knobs(monkeypatch):
    for var in ("HVQ_BENCH_STORE", "HVQ_BENCH_DTYPE", "HVQ_BENCH_SCAN_IMPL"):
        monkeypatch.delenv(var, raising=False)
    assert bench.engine_kwargs_from_env(10**6) == {}
    assert bench.engine_kwargs_from_env(4 * 10**6) == {"scan_store": "bf16"}
    monkeypatch.setenv("HVQ_BENCH_SCAN_IMPL", "pallas")
    monkeypatch.setenv("HVQ_BENCH_REPAIR_GATE", "0")
    monkeypatch.setenv("HVQ_BENCH_DTYPE", "bf16")
    assert bench.engine_kwargs_from_env(10) == dict(
        scan_impl="pallas", repair_gate=False, dtype=torch.bfloat16, precision="default")


def test_runner_refuses_to_run_without_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("HVQ_BENCH_PLATFORM", raising=False)
    with pytest.raises(SystemExit, match="HVQ_BENCH_PLATFORM=cpu"):
        bench.bench_device()
    monkeypatch.setenv("HVQ_BENCH_PLATFORM", "cpu")
    assert bench.bench_device() == torch.device("cpu")


_FOREIGN = ("print(sorted(m for m in sys.modules if m in ('jax', 'hvq_tpu', 'experiments', "
            "'bench') or m.startswith(('jax.', 'hvq_tpu.', 'experiments.'))))\n")


def _run_bench(code: str, **env):
    full = {**os.environ, "HVQ_BENCH_PLATFORM": "cpu", "HVQ_BENCH_N": "4096",
            "HVQ_BENCH_Q": "256", "HVQ_BENCH_CACHE": "", **env}
    full.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full,
                          capture_output=True, text=True, timeout=300)


def _json_lines(stdout: str) -> list:
    return [json.loads(s) for s in stdout.splitlines() if s.startswith("{")]


@pytest.mark.parametrize("engine,partner", [("batched", "partitioned"),
                                            ("partitioned", "batched")])
def test_cpu_run_prints_the_jax_record_and_leaves_jax_unloaded(engine, partner):
    proc = _run_bench("import sys\nfrom hvq_tpu_torch.tools import bench\n"
                      "bench.main()\n" + _FOREIGN, HVQ_BENCH_ENGINE=engine)
    assert proc.returncode == 0, proc.stderr
    lines = _json_lines(proc.stdout)
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    first, last = lines[0], lines[-1]
    assert len(lines) == 2 and set(first) <= set(last)
    assert JAX_KEYS | {"backend", "device", "torch", "launches", "launches_by_body"} <= set(last)
    assert last["backend"] == "torch" and last["device"] == "cpu"
    assert last["engine"] == engine and last["timed_runs"] == 3 and len(last["run_qps"]) == 3
    assert last["value"] in last["run_qps"] and last["unit"] == "queries/s"
    assert last["metric"] == "exact_hybrid_knn_qps_D4096_Q256"
    assert last["checked_queries"] == 64 and last["recall_at_100"] == 1.0
    assert last["dist_check"] == "same" and last["full_diff"] == "same"
    assert last["full_diff_queries"] == 256
    assert last["full_diff_engines"] == [engine, f"{partner}_fp32"]
    # the wrappers count kernel launches only: none on the CPU
    assert set(last["launches"].values()) == {0}
    assert "search_phases_ms" in last and last["scan_impl"] == "v3"


_FAULTS = {
    # the partner's build (batched's partner is partitioned)
    "partner": ("from hvq_tpu_torch.models import registry\n"
                "real = registry.get_engine\n"
                "def fake(name):\n"
                "    if name == 'partitioned':\n"
                "        raise RuntimeError('failed on purpose')\n"
                "    return real(name)\n"
                "registry.get_engine = fake\n"),
    # the oracle check, on its host thread
    "oracle": ("from hvq_tpu_torch.models import oracle\n"
               "def fake(*a, **k):\n"
               "    raise RuntimeError('failed on purpose')\n"
               "oracle.search_oracle_batched = fake\n"),
}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_a_failing_check_exits_non_zero_after_the_first_line(fault):
    proc = _run_bench(_FAULTS[fault] + "import runpy\n"
                      "runpy.run_module('hvq_tpu_torch.tools.bench', run_name='__main__')\n",
                      HVQ_BENCH_ENGINE="batched")
    assert proc.returncode != 0
    lines = _json_lines(proc.stdout)
    assert len(lines) == 1 and lines[0]["timed_runs"] == 3 and "full_diff" not in lines[0]
    assert ("recall_at_100" in lines[0]) == (fault == "partner")
    assert "failed on purpose" in proc.stderr and "Traceback" in proc.stderr
