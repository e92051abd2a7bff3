"""Whole runs of the harness on the CPU at a tiny size, with the engines'
plain PyTorch kernels: correct as the port stands, not correct with the
timed path broken or the control in the program's place; the command
itself without a card; and the modules a run loads."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from hvq_bench import control, harness, spec  # noqa: E402

SEED = 2 ** 31 + 11     # seeds reach past 32 signed bits


def tiny(name: str):
    """The cell ``name`` at a size a test run holds: its engine and traffic
    types, 20,000 rows in 30 categories, short calls; the partitioned
    engine with narrow route buckets and small query batches, so that
    routed groups, full batches and windowed batches all run."""
    cell = spec.cell(name)
    cfg, tr = dict(cell.config), dict(cell.traffic)
    cfg.update(rows=20_000, C=dict(cfg["C"], levels=30))
    cfg["keywords"] = dict(cfg["keywords"], db_tile=512, query_batch=32, route_buckets=[512],
                           time_view_min_queries=1)
    tr.update(call_queries=512, pool_calls=3, check_queries=256, trace_calls=2,
              fenced_calls=1)
    cell.config, cell.traffic = cfg, tr
    return cell


CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("traced", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_a_run_of_the_port_is_correct(name, traced):
    cell = tiny(name)
    out = harness.run(cell, SEED, 0.5, traced, device="cpu")
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["check"]["judged"] > 0
    got = harness.metrics(cell, out["record"], traced)
    if traced:
        # the spans and counters read on the CPU; device metrics need a card
        for m in cell.per_layer:
            if m["source"] in ("program_span", "program_counter") and m["name"] in got:
                assert got[m["name"]]["value"] >= 0
        assert not any(k.startswith(("k1_", "device_idle")) for k in got)
    else:
        # every end-to-end metric but the card's memory, which the CPU lacks
        assert set(got) == {m["name"] for m in cell.end_to_end} - {"card_bytes_per_row"}


def test_the_mixed_cell_drives_every_route():
    routes = []

    def engine(cfg, ds, device):
        eng = harness.program_engine(cfg, ds, device)
        search = eng.search

        def recorded(*args, **kw):
            out = search(*args, **kw)
            routes.append(eng.last_route)
            return out
        eng.search = recorded
        return eng

    out = harness.run(tiny("sigmod-10m.mixed"), SEED, 0.5, False, device="cpu",
                      engine=engine)
    assert out["correct"]
    for key in ("full", "windowed", "routed_cat", "routed_time"):
        assert sum(r[key] for r in routes) > 0, key
    assert sum(r["ladder"].get("rung1_runs", 0) for r in routes) > 0
    # the ladder's answers are among those judged
    assert out["check"]["reruns_judged"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    out = harness.run(tiny(name), SEED, 0.5, False, device="cpu",
                      engine=control.ControlEngine)
    assert not out["correct"]
    value, limit = out["check"]["numbers"]["dist_gap"]
    assert value > limit


def _altered_finalize(finalize):
    """Each answer's nearest id replaced by its neighbour's id."""
    def broken(*args, **kw):
        ids, d = finalize(*args, **kw)
        ids = ids.clone()
        ids[:, 0] += 1
        return ids, d
    return broken


def _half_left_out(search):
    """Half of each call's queries never searched: they get the first
    half's answers."""
    def broken(self, qs, *args, **kw):
        ids, d = search(self, qs, *args, **kw)
        h = (ids.shape[0] + 1) // 2
        ids = ids.copy()
        ids[h:] = ids[: ids.shape[0] - h]
        return ids, d
    return broken


def _one_answer_missing(search):
    """Every third call returns no answer of the right shape."""
    state = {"calls": 0}

    def broken(self, qs, *args, **kw):
        ids, d = search(self, qs, *args, **kw)
        state["calls"] += 1
        return (ids[:0] if state["calls"] % 3 == 0 else ids), d
    return broken


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out", "answer_missing"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = tiny(name)
    if fault == "answer_altered":
        from hvq_tpu_torch.models import common
        monkeypatch.setattr(common, "finalize", _altered_finalize(common.finalize))
    elif fault == "answer_missing":
        from hvq_tpu_torch.models.registry import get_engine
        cls = get_engine(cell.config["engine"])
        monkeypatch.setattr(cls, "search", _one_answer_missing(cls.search))
    else:
        from hvq_tpu_torch.models.registry import get_engine
        cls = get_engine(cell.config["engine"])
        monkeypatch.setattr(cls, "search", _half_left_out(cls.search))
    out = harness.run(cell, SEED, 0.5, False, device="cpu")
    assert not out["correct"] and out["failed"] > 0
    assert (out["check"]["numbers"]["missing"][0] > 0) == (fault == "answer_missing")


def test_command_exits_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, str(ROOT / "hvq_bench" / "run.py"), "--workload",
         "sigmod-10m.mixed", "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode != 0
    assert not any(line.startswith("{") for line in res.stdout.splitlines())


def test_a_run_loads_no_jax_module():
    """A harness run in a fresh interpreter, then the command's own check
    of the loaded modules' top-level names."""
    code = f"""
import sys, importlib.util
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(Path(__file__).parent)!r})
from test_hvqbench_run import tiny, SEED
from hvq_bench import harness
out = harness.run(tiny("sigmod-10m.mixed"), SEED, 0.3, True, device="cpu")
assert out["correct"]
s = importlib.util.spec_from_file_location("bench_run", {str(ROOT / "hvq_bench" / "run.py")!r})
run = importlib.util.module_from_spec(s); s.loader.exec_module(run)
print("BANNED", run.banned_modules())
print("TOP", sorted({{n.split(".")[0] for n in sys.modules}} & {{"jax", "jaxlib", "flax", "hvq_tpu"}}))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "BANNED []" in res.stdout and "TOP []" in res.stdout, res.stdout


def test_banned_names_are_whole_words(monkeypatch):
    s = importlib.util.spec_from_file_location("bench_run", ROOT / "hvq_bench" / "run.py")
    run = importlib.util.module_from_spec(s)
    s.loader.exec_module(run)
    for name in ("hvq_tpu_torch_like", "jaxlike", "hvq_tpu_torch.toolsy",
                 "jax.numpy", "hvq_tpu.models", "hvq_tpu_torch.tools.bench"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = run.banned_modules()
    assert {"jax.numpy", "hvq_tpu.models", "hvq_tpu_torch.tools.bench"} <= set(found)
    assert not {"hvq_tpu_torch_like", "jaxlike", "hvq_tpu_torch.toolsy"} & set(found)


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of the mixed cell through the command, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    res = subprocess.run(
        [sys.executable, str(ROOT / "hvq_bench" / "run.py"), "--workload",
         "sigmod-10m.mixed", "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"qps.mixed", "card_bytes_per_row", "setup_s"}
