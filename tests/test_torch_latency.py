"""The port's serving-latency tool (``hvq_tpu_torch.tools.serving_latency``)
against ``experiments/serving_latency.py``: the same percentile indices,
and a run on the CPU.

The experiment's ``stats`` is taken from its source (it is not imported:
importing the script sets a jax compilation-cache directory).
"""

import ast
import contextlib
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest

from hvq_tpu_torch.tools import serving_latency

SCRIPT = Path(__file__).resolve().parents[1] / "experiments" / "serving_latency.py"


def _jax_stats():
    tree = ast.parse(SCRIPT.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "stats")
    ns = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(SCRIPT), "exec"), ns)
    return ns["stats"]


@pytest.mark.parametrize("count,seed", [(1, 0), (4, 1), (50, 2), (199, 3), (200, 4)])
def test_percentiles_take_the_experiments_indices(count, seed):
    walls = np.random.default_rng(seed).lognormal(1.0, 0.8, count) * 3.0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _jax_stats()("tag", list(walls), 0)
    text = out.getvalue()
    want = [float(text.split(f"{k} ")[1].split()[0]) for k in ("p50", "p95", "p99", "max")]
    got = serving_latency.percentiles(walls)
    assert [round(got[k], 2) for k in ("p50_ms", "p95_ms", "p99_ms", "max_ms")] == want
    w = np.sort(walls)
    assert got["p99_ms"] == w[int(0.99 * (count - 1))] and got["max_ms"] == w[-1]


def test_cpu_run_prints_a_json_line_after_each_text_line(monkeypatch, capsys):
    monkeypatch.setenv("SL_N", "4096")
    monkeypatch.setenv("SL_CALLS", "4")
    monkeypatch.delenv("SL_ENGINES", raising=False)
    recs = serving_latency.main("cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 8
    for text, js in zip(lines[::2], lines[1::2]):
        rec = json.loads(js)
        assert text.startswith(rec["engine"]) and f"B={rec['batch']:2d}" in text
        assert f"rerun calls {rec['rerun_calls']}/4" in text
    assert [(r["engine"], r["batch"]) for r in recs] == [
        ("batched", 1), ("batched", 16), ("partitioned", 1), ("partitioned", 16)]
    for r in recs:
        assert r["calls"] == 4 and r["n"] == 4096 and r["device"] == "cpu"
        assert r["backend"] == "torch"
        assert 0 < r["p50_ms"] <= r["p95_ms"] <= r["p99_ms"] <= r["max_ms"]


def test_rerun_calls_count_the_calls_whose_ladder_ran(monkeypatch):
    """A call counts as a rerun when its ``last_ladder`` had suspects; the
    engines are built as by default (no forensics mode)."""
    from hvq_tpu_torch.models import registry

    class Every2nd:
        def __init__(self, ds, **kw):
            assert "HVQ_CERT_TERMS" not in os.environ
            self.calls = 0

        def search(self, qs, return_dists=True):
            assert not return_dists
            self.last_ladder = dict(suspects=self.calls % 2)
            self.calls += 1
            return None, None

    monkeypatch.setattr(registry, "get_engine", lambda name: Every2nd)
    monkeypatch.setenv("SL_N", "4096")
    monkeypatch.setenv("SL_CALLS", "4")
    monkeypatch.setenv("SL_ENGINES", "batched")
    monkeypatch.delenv("HVQ_CERT_TERMS", raising=False)
    recs = serving_latency.main("cpu")
    # 2 warm calls, then 4 at B = 1 and 4 at B = 16: calls 3, 5, 7 and 9
    # (from 0) rerun
    assert [r["rerun_calls"] for r in recs] == [2, 2]
