"""BENCHMARK.json resolves to the files of hvq_bench/, and keeps the
contract's shape: names, units, bounds, and what each cell reports."""

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from hvq_bench import spec, traffic  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["hvq_bench"]
    assert SPEC["command"] == ["python3", "hvq_bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("hvq_bench/")
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"] == []
    assert len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200
    spec.load_module("generators", body["generator"])
    spec.load_module("checks", body["check"])
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


def check_cell_entry(w: dict) -> None:
    """A ``workloads`` entry's shape: its keys, names, cards (one or four)
    and a one-line ``why``."""
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def four_card_cells_allowed(workloads: list) -> bool:
    """At most a quarter of the cells, rounded down, ask for four cards;
    one always may."""
    fours = sum(w["chips"] == 4 for w in workloads)
    return fours <= max(1, len(workloads) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_and_reports(name):
    w = next(w for w in SPEC["workloads"] if w["name"] == name)
    check_cell_entry(w)
    cell = spec.cell(name)
    traffic.check(cell.traffic)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], name)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m).read)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_shape(m):
    keys = {"name", "unit", "better", "source", "workloads"}
    if m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        assert set(m) <= keys | {"layer", "moves"} and "layer" in m and "moves" in m
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert (ROOT / "hvq_bench" / "metrics" / f"{m['name']}.py").is_file()


def test_names_unique_and_layers_consistent():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))
    assert "setup_s" in names
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in SPEC["per_layer"]:
        if m["name"].startswith(("k1_", "device_idle")):
            assert m["source"] == "device_trace"


def _cells(chips: list) -> list:
    return [{"name": f"c{i}", "config": "sigmod-10m", "traffic": f"t{i}", "chips": n,
             "why": "a cell"} for i, n in enumerate(chips)]


def test_a_four_card_cell_entry_passes():
    w = _cells([4])[0]
    check_cell_entry(w)
    with pytest.raises(AssertionError):
        check_cell_entry(dict(w, chips=2))


def test_four_card_cells_within_the_limit():
    assert four_card_cells_allowed(SPEC["workloads"])
    assert four_card_cells_allowed(_cells([4]))                       # one always may
    assert four_card_cells_allowed(_cells([1, 1, 1, 4]))              # a quarter of four
    assert not four_card_cells_allowed(_cells([1, 1, 4, 4]))          # two among four
    assert four_card_cells_allowed(_cells([1] * 6 + [4, 4]))          # two among eight
    assert not four_card_cells_allowed(_cells([1] * 8 + [4, 4, 4]))   # 11 // 4 = 2
