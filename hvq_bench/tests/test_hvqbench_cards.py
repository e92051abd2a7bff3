"""The cell's own cards: the choice of ``CUDA_VISIBLE_DEVICES``, the
command applying it before CUDA starts, a four-shard cell through the
harness on the CPU, and on a host of four cards or more a four-card cell
with its peaks and busy times on every card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from hvq_bench import cards, harness, spec  # noqa: E402

SEED = 2 ** 31 + 23


def test_select_with_no_list():
    assert cards.select(1, None) == "0"
    assert cards.select(4, None) == "0,1,2,3"


def test_select_keeps_a_given_list_in_its_order():
    assert cards.select(1, "0,1,2,3") == "0"            # a one-card cell: card 0 alone
    assert cards.select(1, "3,1,2") == "3"
    assert cards.select(4, "7, 5,6,4,3") == "7,5,6,4"
    uuids = "GPU-aa,GPU-bb,GPU-cc,GPU-dd,GPU-ee"
    assert cards.select(4, uuids) == "GPU-aa,GPU-bb,GPU-cc,GPU-dd"


def test_select_with_fewer_cards_than_asked():
    assert cards.select(4, "0,1,2") is None
    assert cards.select(1, "") is None
    with pytest.raises(ValueError):
        cards.select(0, None)


def test_restrict_sets_the_list_or_leaves_it(monkeypatch):
    monkeypatch.setenv(cards.ENV, "2,0,1,3,5")
    assert cards.restrict(4) and os.environ[cards.ENV] == "2,0,1,3"
    monkeypatch.setenv(cards.ENV, "1")
    assert not cards.restrict(4) and os.environ[cards.ENV] == "1"
    monkeypatch.delenv(cards.ENV)
    assert cards.restrict(1) and os.environ[cards.ENV] == "0"


@pytest.mark.parametrize("listed, shown", [("0,1,2,3", "0"), ("3,1,2", "3")])
def test_the_command_shows_a_one_card_cell_its_first_card(listed, shown):
    """``run.py`` narrows the list before torch starts CUDA; on a host
    without the listed card it then exits with no result."""
    env = dict(os.environ, **{cards.ENV: listed})
    res = subprocess.run(
        [sys.executable, str(ROOT / "hvq_bench" / "run.py"), "--workload",
         "sigmod-10m.mixed", "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert f"cards: {cards.ENV}={shown} (was '{listed}')" in res.stderr, res.stderr[-2000:]
    if not torch.cuda.is_available():
        assert res.returncode != 0
        assert not any(line.startswith("{") for line in res.stdout.splitlines())


def sharded_cell(rows: int, **keywords) -> spec.Cell:
    """A four-card cell of the mixed traffic over ``rows`` rows on the
    ``partitioned_sharded`` engine, with short calls."""
    cell = spec.cell("sigmod-10m.mixed")
    cfg, tr = dict(cell.config), dict(cell.traffic)
    cfg.update(rows=rows, engine="partitioned_sharded",
               keywords=dict(cfg["keywords"], route_buckets=[4096, 32768, 65536], **keywords))
    tr.update(call_queries=4096, pool_calls=2, warmup_calls=1, check_queries=1024,
              check_reruns=512, trace_calls=1, fenced_calls=1)
    cell.chips, cell.config, cell.traffic = 4, cfg, tr
    return cell


@pytest.mark.parametrize("traced", [False, True], ids=["window", "traced"])
def test_a_four_shard_cell_on_the_cpu(traced):
    """The harness drives the mesh engine over four CPU shards (the CPU has
    no cards to read), and the check holds it to the reference."""
    from hvq_tpu_torch.parallel.mesh import make_mesh

    cell = sharded_cell(20_000, db_tile=512, query_batch=32)
    cell.config["C"] = dict(cell.config["C"], levels=30)
    cell.config["keywords"]["route_buckets"] = [512]
    cell.traffic.update(call_queries=512, check_queries=256, check_reruns=256)
    meshes = []

    def engine(cfg, ds, device):
        meshes.append(make_mesh(devices=["cpu"] * 4))
        return harness.program_engine(dict(cfg, keywords=dict(cfg["keywords"],
                                                              mesh=meshes[-1])), ds, device)

    out = harness.run(cell, SEED, 0.3, traced, device="cpu", engine=engine)
    assert out["correct"], out["check"]
    assert out["check"]["judged"] > 0 and meshes[0].shape["d"] == 4
    rec = out["record"]
    assert rec["chips"] == 4 and rec["memory_peak_bytes_by_card"] == []
    if traced:
        assert rec["profile"]["busy_s_by_card"] == []


@pytest.mark.cuda
def test_a_four_card_cell_on_the_cards():
    """``harness.run`` on a four-card ``partitioned_sharded`` cell at 2²²
    rows, in a process shown four cards: correct, and a peak and a busy
    time on each card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(Path(__file__).parent)!r})
from hvq_bench import cards
assert cards.restrict(4)
import torch
from test_hvqbench_cards import sharded_cell, SEED
from hvq_bench import harness
out = harness.run(sharded_cell(1 << 22), SEED, 2.0, True, device="cuda")
rec = out["record"]
print(json.dumps(dict(correct=out["correct"], visible=torch.cuda.device_count(),
                      peaks=rec["memory_peak_bytes_by_card"], peak=rec["memory_peak_bytes"],
                      busy=rec["profile"]["busy_s_by_card"], union=rec["profile"]["busy_s"],
                      checks=out["check"]["numbers"], last_route=rec["last_route"]),
                 default=str))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["correct"], got["checks"]
    assert got["visible"] == 4
    assert len(got["peaks"]) == 4 and all(p > 0 for p in got["peaks"])
    assert got["peak"] == max(got["peaks"])
    assert len(got["busy"]) == 4 and all(b > 0 for b in got["busy"])
    assert all(b <= got["union"] for b in got["busy"]) and sum(got["busy"]) >= got["union"]
