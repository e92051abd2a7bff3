"""The readers of the program's own spans (``span_readers``) over
hand-made records, against hand-computed values, and None where a record
(a program without the ``routed/pack`` span, a run without a card) holds
nothing for them."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from hvq_bench import span_readers, spec  # noqa: E402


def traced_record(**kw):
    # 3 profiled calls, 3 again unprofiled, 2 fenced: 40,000 queries each
    rec = dict(spans={"search/route": {"s": 0.004, "n": 2},
                      "routed/pack": {"s": 0.120, "n": 24},
                      "batch/select": {"s": 0.56, "n": 40}},
               fenced_queries=80_000, traced_calls=8, traced_queries=320_000,
               profile=dict(window_s=2.0, busy_s=1.0, device_events=10,
                            idle_gaps=[["search/route", 0.5], ["search/fetch", 0.2],
                                       ["routed/pack > aten::copy_", 0.25], ["host", 0.05],
                                       ["search/routed > aten::eq", 0.01]]),
               k1_launches=[dict(B=1024, rows=10_000_000, W=234_624, plane_bytes=2)] * 60)
    rec.update(kw)
    return rec


def test_routed_pack_us_per_query():
    assert span_readers.routed_pack_us_per_query(traced_record()) == pytest.approx(1.5)
    spans = {"search/route": {"s": 0.004, "n": 2}}
    assert span_readers.routed_pack_us_per_query(traced_record(spans=spans)) is None


def test_select_fenced_roofline_pct_by_hand():
    # one read of 60 launches' (1024, 234,624) fp32 scores: 60 · 0.96 GB at
    # 3.35 TB/s over 120,000 profiled queries, against 0.56 s of fenced
    # select over 80,000 queries (7 µs a query): ≈ 2 %
    least = 60 * 4 * 1024 * 234_624 / 3.35e12
    assert span_readers.select_least_s(traced_record()["k1_launches"]) == pytest.approx(least)
    want = 100 * (least / 120_000) / (0.56 / 80_000)
    got = span_readers.select_fenced_roofline_pct(traced_record())
    assert got == pytest.approx(want) and got == pytest.approx(2.049, abs=0.001)
    # nothing to read: no launch, no select span, no device
    assert span_readers.select_fenced_roofline_pct(traced_record(k1_launches=[])) is None
    assert span_readers.select_fenced_roofline_pct(traced_record(spans={})) is None
    prof = dict(traced_record()["profile"], device_events=0)
    assert span_readers.select_fenced_roofline_pct(traced_record(profile=prof)) is None


def test_idle_routing_pct_by_hand():
    # route 0.5 s and the packer 0.25 s of the gaps, over a 2 s profiled wall
    assert span_readers.idle_routing_pct(traced_record()) == pytest.approx(37.5)
    # a program without the packer's span, or a run without a card
    spans = {"search/route": {"s": 0.004, "n": 2}}
    assert span_readers.idle_routing_pct(traced_record(spans=spans)) is None
    prof = dict(traced_record()["profile"], device_events=0)
    assert span_readers.idle_routing_pct(traced_record(profile=prof)) is None


@pytest.mark.parametrize("name", [
    "routed_pack_us_per_query.mixed", "routed_pack_us_per_query.category",
    "select_fenced_roofline_pct.mixed", "select_fenced_roofline_pct.unfiltered",
    "idle_routing_pct.mixed", "idle_routing_pct.category"])
def test_metric_files_read_the_span_readers(name):
    rec = traced_record()
    quantity = name.split(".")[0].removesuffix("_us_per_query").removesuffix("_pct")
    fn = {"routed_pack": span_readers.routed_pack_us_per_query,
          "select_fenced_roofline": span_readers.select_fenced_roofline_pct,
          "idle_routing": span_readers.idle_routing_pct}[quantity]
    assert spec.load_module("metrics", name).read(rec) == fn(rec)
