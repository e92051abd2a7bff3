"""What ``BENCHMARK.json`` names, resolved to the files of this folder.

Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own, found by its name:

* a configuration ``<config>``: ``configs/<config>.json``; its ``generator``
  names ``generators/<generator>.py`` and its ``check`` names
  ``checks/<check>.py``;
* a traffic mix ``<traffic>``: ``workloads/<traffic>.json``;
* a metric ``<metric>``, end to end or per layer: ``metrics/<metric>.py``,
  whose ``read(rec)`` returns its value, or None where the record holds
  nothing for it to read.

A cell, a configuration or a metric is added by adding its files and its
entries in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of this folder (a name may hold
    dots, so it is loaded by its path)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no {path.relative_to(ROOT)}")
    mod_spec = importlib.util.spec_from_file_location(
        f"hvq_bench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list

    def reader(self, metric: dict):
        return load_module("metrics", metric["name"])


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, or every cell where it lists none."""
    return cell in metric.get("workloads", [cell])


def cell(name: str) -> Cell:
    spec = load_json(SPEC)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in spec['workloads']]}")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = load_json(HERE / "workloads" / f"{entry['traffic']}.json")
    return Cell(
        name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if reports(m, name)],
    )
