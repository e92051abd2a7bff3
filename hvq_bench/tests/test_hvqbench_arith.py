"""The rate, percentile, idle-union and roofline arithmetic, and
the readers over hand-made records, against hand-computed values."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from hvq_bench import readers, spec, stats  # noqa: E402


def test_rate_and_percentiles():
    assert stats.rate(400_000, 8.0) == 50_000.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    walls = [float(x) for x in range(1, 101)]          # 1 … 100
    assert stats.percentile(walls, 0.50) == 50.0        # index int(0.5·99) = 49
    assert stats.percentile(walls, 0.95) == 95.0        # index int(0.95·99) = 94
    assert stats.percentile(list(reversed(walls)), 0.95) == 95.0


def test_busy_union_and_gaps():
    iv = [(1, 3), (2, 4), (6, 7), (9, 12), (-5, 0)]
    busy, gaps = stats.busy_union(iv, 0, 10)
    assert busy == 3 + 1 + 1              # [1, 4), [6, 7), [9, 10)
    assert gaps == [(0, 1), (4, 6), (7, 9)]
    busy, gaps = stats.busy_union([], 0, 2)
    assert busy == 0 and gaps == [(0, 2)]


def test_packed_scan_bound_by_hand():
    # K1 at D = 10⁷ on the bf16 plane, B = 1024, R = 3:
    # ops 2·1024·10⁷·100 = 2.048e12 → 2.0708 ms at 989 TFLOP/s;
    # bytes 10⁷·(100·2 + 16) + 1024·(400 + 24) + 1024·W·8: data lanes, not padding
    B, rows, W = 1024, 10_000_000, 3 * (10_000_000 // 128)
    assert stats.packed_scan_ops(B, rows) == 2.048e12
    nbytes = 10_000_000 * 216 + 1024 * 424 + 1024 * W * 8
    assert stats.packed_scan_bytes(B, rows, W, 2) == nbytes
    least = stats.packed_scan_least_s(B, rows, W, 2)
    assert least == pytest.approx(max(2.048e12 / 989e12, nbytes / 3.35e12))
    assert least == pytest.approx(2.048e12 / 989e12)          # operations bound
    # K1 at D = 10⁶ on the fp32 plane, B = 16: the bytes bound,
    # 10⁶·(100·4 + 16) + 16·424 + 16·W·8
    b = stats.packed_scan_bytes(16, 10 ** 6, 3 * 7813, 4)
    assert b == 416_000_000 + 16 * 424 + 16 * 3 * 7813 * 8
    assert stats.packed_scan_least_s(16, 10 ** 6, 3 * 7813, 4) == pytest.approx(b / 3.35e12)


def traced_record(**kw):
    rec = dict(spans={"search/route": {"s": 0.004, "n": 2},
                      "batch/select": {"s": 0.5, "n": 40}},
               fenced_queries=80_000, traced_calls=4, traced_queries=160_000,
               unprofiled_s=1.6,
               suspects=[120, 0, 100, 0],
               profile=dict(window_s=2.0, busy_s=1.5, device_events=10,
                            k1_device_s=0.030, k1_kernels=2),
               k1_launches=[dict(B=1024, rows=10_000_000, W=234375, plane_bytes=2)] * 2)
    rec.update(kw)
    return rec


def test_readers_on_a_traced_record():
    rec = traced_record()
    assert readers.span_us_per_query(rec, "search/route") == pytest.approx(0.05)
    assert readers.span_us_per_query(rec, "batch/select") == pytest.approx(6.25)
    assert readers.span_us_per_query(rec, "search/nothing") is None
    assert readers.suspects_per_kquery(rec) == pytest.approx(220 / 160)
    # busy 1.5 s of the same calls' 1.6 s without the profiler (2.0 s with it)
    assert readers.device_idle_pct(rec) == pytest.approx(6.25)
    least = stats.packed_scan_least_s(1024, 10_000_000, 234375, 2)
    assert readers.k1_roofline_pct(rec) == pytest.approx(100 * 2 * least / 0.030)
    # nothing to read: no launch, no device, or launches that do not match
    assert readers.k1_roofline_pct(traced_record(k1_launches=[])) is None
    assert readers.k1_roofline_pct(traced_record(
        profile=dict(rec["profile"], k1_kernels=3))) is None
    assert readers.device_idle_pct(traced_record(
        profile=dict(rec["profile"], device_events=0))) is None


def test_busy_by_card():
    iv = [(1, 3, 0), (2, 4, 1), (6, 7, 0), (9, 12, 3), (-5, 0, 2), (3.5, 5, 2)]
    union, _ = stats.busy_union([(a, b) for a, b, _ in iv], 0, 10)
    assert union == 3 + 1 + 1 + 1         # [1, 5), [6, 7), [9, 10)
    # one card: its union is the union, to the last bit
    one = [(a, b, 0) for a, b, _ in iv]
    assert stats.busy_by_card(one, 0, 10, [0]) == [union]
    # four cards: [1, 3) ∪ [6, 7); [2, 4); [3.5, 5) (and one before the window); [9, 10)
    by_card = stats.busy_by_card(iv, 0, 10, [0, 1, 2, 3])
    assert by_card == [3, 2, 1.5, 1]
    assert all(b <= union for b in by_card) and sum(by_card) >= union
    # a card of the cell with nothing on it reads 0; one outside the cell is not read
    assert stats.busy_by_card(iv, 0, 10, [1, 5]) == [2, 0]


def test_card_bytes_per_row_on_one_and_four_cards():
    one = dict(rows=10_000_000, chips=1, memory_peak_bytes=19_588_000_000,
               memory_peak_bytes_by_card=[19_588_000_000])
    assert readers.card_bytes_per_row(one) == 1958.8
    # four cards serve 10⁷ rows each: the fullest card's peak over its rows
    by_card = [47_000_000_000, 21_000_000_000, 21_000_000_000, 20_500_000_000]
    four = dict(rows=40_000_000, chips=4, memory_peak_bytes=max(by_card),
                memory_peak_bytes_by_card=by_card)
    assert readers.card_bytes_per_row(four) == 4700.0
    assert readers.card_bytes_per_row(dict(four, memory_peak_bytes=0)) is None


def test_end_to_end_readers():
    rec = dict(setup_s=12.5, window_s=10.0, queries=500_000,
               walls_s=[0.001 * x for x in range(1, 101)],
               memory_peak_bytes=2_000_000_000, memory_peak_bytes_by_card=[2_000_000_000],
               rows=1_000_000, chips=1)
    names = [m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["end_to_end"]]
    read = {name: spec.load_module("metrics", name).read(rec) for name in names}
    want = {"card_bytes_per_row": 2000.0, "setup_s": 12.5}
    assert read == pytest.approx({n: want.get(n, 50_000.0) for n in names})
    assert {n for n in names if n not in want} == {"qps.mixed", "qps.unfiltered", "qps.category"}
    assert spec.load_module("metrics", "card_bytes_per_row").read(
        dict(rec, memory_peak_bytes=0)) is None
