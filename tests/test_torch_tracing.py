"""The port's own spans and counters (``utils.timing``): off, a search
records nothing; on, every phase of a call is a span inside its parent
under one ``search`` root, the routed packer has a span of its own, K1's
launches and the rerun ladder's suspects are logged where the work
happens (the level-2 select's too), and the spans share the profiler's
clock. The card-only case
(marked ``cuda``) checks that the tracer adds no synchronisation:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import contextlib
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from hvq_tpu_torch import get_engine
from hvq_tpu_torch.models import partitioned
from hvq_tpu_torch.ops import kernels
from hvq_tpu_torch.utils import formats, profiling, timing
from hvq_tpu_torch.utils.formats import QuerySet
from hvq_tpu_torch.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch.utils.timing import PhaseTimer, maybe_phase, recording


FIELDS = ("qtype", "v", "l", "r", "V")


def _rows(qs, sl) -> QuerySet:
    return QuerySet(**{f: getattr(qs, f)[sl] for f in FIELDS})


def _queries(ds, m=256, seed=2):
    """Mixed queries, plus 96 type-2 queries over a tenth of the time
    range each, so that full, windowed and routed batches all run."""
    qs = generate_queries(m, seed=seed, categories=30)
    rng = np.random.default_rng(seed)
    lo = np.sort(rng.uniform(float(ds.T.min()), float(np.quantile(ds.T, 0.85)), 96))
    w = np.float32(0.1 * (float(ds.T.max()) - float(ds.T.min())))
    t2 = QuerySet(qtype=np.full(96, 2, qs.qtype.dtype), v=qs.v[:96],
                  l=lo.astype(qs.l.dtype), r=(lo + w).astype(qs.r.dtype), V=qs.V[:96])
    return QuerySet(**{f: np.concatenate([getattr(qs, f), getattr(t2, f)]) for f in FIELDS})


@pytest.fixture(scope="module")
def setup():
    ds = generate_dataset(20_000, seed=1, categories=30)
    eng = get_engine("partitioned")(ds, device="cpu", db_tile=512, query_batch=32,
                                    route_buckets=(512,), time_view_min_queries=1)
    qs = _queries(ds)
    eng.search(qs)                      # builds the time view
    return ds, eng, qs


def _traced(eng, qs, **kw):
    tracer = PhaseTimer("cpu", fence=False)
    with recording(tracer):
        ids, _ = eng.search(qs, **kw)
    return ids, tracer.export()


def test_tracer_off_records_nothing_and_changes_no_answer(setup):
    _, eng, qs = setup
    idle = PhaseTimer("cpu", fence=False)
    assert timing.active_tracer is None
    ids_off, _ = eng.search(qs)
    ids_on, program = _traced(eng, qs)
    np.testing.assert_array_equal(ids_off, ids_on)
    assert idle.spans == [] and idle.counters == [] and timing.active_tracer is None
    assert program["spans"] and program["counters"]


def test_every_span_lies_inside_its_parent(setup):
    _, eng, qs = setup
    _, program = _traced(eng, qs)
    spans = {s["id"]: s for s in program["spans"]}
    assert len(spans) == len(program["spans"])
    for s in spans.values():
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            up = spans[s["parent"]]
            assert up["start_ns"] <= s["start_ns"] and s["end_ns"] <= up["end_ns"], s
            assert s["call"] == up["call"]
        else:
            assert s["call"] == s["id"]
    for c in program["counters"]:
        s = spans[c["span"]]
        assert s["start_ns"] <= c["t_ns"] <= s["end_ns"] and c["call"] == s["call"]


def test_each_call_has_one_search_root_with_its_query_count(setup):
    _, eng, qs = setup
    tracer = PhaseTimer("cpu", fence=False)
    half = _rows(qs, slice(100))
    with recording(tracer):
        eng.search(qs)
        eng.search(half, return_dists=False)
    spans = tracer.export()["spans"]
    roots = [s for s in spans if s["parent"] is None]
    assert [(s["name"], s["queries"]) for s in roots] == [("search", qs.m), ("search", 100)]
    assert {s["call"] for s in spans} == {s["id"] for s in roots}
    names = Counter(s["name"] for s in spans)
    assert names["search"] == 2 and names["search/route"] == 2 and names["search/fetch"] == 2


def test_routed_pack_runs_inside_search_routed(setup):
    _, eng, qs = setup
    _, program = _traced(eng, qs)
    route = eng.last_route
    assert route["routed_cat"] + route["routed_time"] > 0
    assert route["windowed"] > 0 and route["full"] > 0
    spans = {s["id"]: s for s in program["spans"]}
    packs = [s for s in spans.values() if s["name"] == "routed/pack"]
    # one a routed view: its groups, then every dispatch's layout
    assert len(packs) == sum(1 for n in (route["routed_cat"], route["routed_time"]) if n)
    assert all(spans[s["parent"]]["name"] == "search/routed" for s in packs)
    # each with its pack counter, which counts what last_route does
    counters = [c for c in program["counters"] if c["name"] == "pack"]
    assert sorted(c["span"] for c in counters) == sorted(s["id"] for s in packs)
    assert sum(c["queries"] for c in counters) == route["routed_cat"] + route["routed_time"]
    assert sum(c["groups"] for c in counters) == sum(route["routed_groups"].values())
    assert sum(c["layouts"] for c in counters) == route["routed_dispatches"]


@pytest.mark.parametrize("name", ["batched", "paged", "ivf", "sharded", "partitioned_sharded"])
def test_every_engine_opens_the_request_span(name):
    ds = generate_dataset(3000, seed=5, categories=20, clusters=8)
    qs = generate_queries(24, seed=6, categories=20)
    kw = dict(batched=dict(db_tile=512, query_batch=8),
              paged=dict(db_tile=512, window_rows=1024, query_batch=8),
              ivf=dict(cap=128, kmeans_iters=2),
              sharded=dict(db_tile=512, query_batch=8),
              partitioned_sharded=dict(db_tile=512, query_batch=8))[name]
    eng = get_engine(name)(ds, device="cpu", **kw)
    ids, program = _traced(eng, qs, return_dists=False)
    assert ids.shape == (qs.m, 100)
    roots = [s for s in program["spans"] if s["parent"] is None]
    assert [(s["name"], s["queries"]) for s in roots] == [("search", qs.m)]
    assert len(program["spans"]) > 1
    if name == "partitioned_sharded" and eng.last_route["routed_dispatches"]:
        spans = {s["id"]: s for s in program["spans"]}
        packs = [s for s in spans.values() if s["name"] == "routed/pack"]
        assert packs and all(spans[s["parent"]]["name"] == "search/routed" for s in packs)


def test_k1_launch_log_equals_what_each_launch_ran(setup, monkeypatch):
    """The log against the arguments and output of the body each launch
    runs (on the CPU, the plain scan)."""
    _, eng, qs = setup
    ran = []
    plain = kernels.packed_scan_plain

    def recorded(Vs, C, T, dn, oid, qV, *args, db_tile, ntw, **kw):
        out = plain(Vs, C, T, dn, oid, qV, *args, db_tile=db_tile, ntw=ntw, **kw)
        ran.append(dict(B=qV.shape[0], rows=ntw * db_tile if ntw else Vs.shape[0],
                        W=out[0].shape[1], plane_bytes=Vs.element_size()))
        return out

    monkeypatch.setattr(kernels, "packed_scan_plain", recorded)
    _, program = _traced(eng, qs)
    logged = [c for c in program["counters"] if c["name"] == "k1_launch"]
    assert ran and [{k: c[k] for k in ("B", "rows", "W", "plane_bytes")}
                    for c in logged] == ran
    assert {c["kernel"] for c in logged} == {"packed_scan_v3"}
    spans = {s["id"]: s for s in program["spans"]}
    assert {spans[c["span"]]["name"] for c in logged} == {"batch/scan"}
    # windowed batches scan fewer rows than the plane
    assert len({c["rows"] for c in logged}) > 1


def test_export_reads_a_count_kept_on_the_device_as_its_number():
    """A counter field that is a one-element tensor (K1's
    ``open_warpgroups``, which the kernel adds to on the card) is read at
    ``export()``, not when it is counted: what the device added after the
    count shows, as a number; other fields pass as they are."""
    tracer = PhaseTimer("cpu", fence=False)
    count = torch.zeros(1, dtype=torch.int32)
    with tracer.phase("search"):
        tracer.count("k1_launch", B=3, warpgroups=4, open_warpgroups=count)
    count += 2
    (c,) = tracer.export()["counters"]
    assert c["open_warpgroups"] == 2 and type(c["open_warpgroups"]) is int
    assert (c["B"], c["warpgroups"], c["name"]) == (3, 4, "k1_launch")


def test_level2_select_is_counted_under_a_tracer_and_runs_plain_on_cpu():
    """The select's counter names what ran (B, W, rounds, layout and body:
    "plain" on the CPU, where no kernel launches) under the open span; with
    no tracer nothing is kept; bad arguments raise."""
    s = torch.from_numpy(np.random.default_rng(3).uniform(0, 9, (4, 5000)).astype(np.float32))
    kernels.reset_launches()
    kernels.level2_select(s, 8)
    tracer = PhaseTimer("cpu", fence=False)
    with recording(tracer), maybe_phase(None, "batch/select"):
        got = kernels.level2_select(s, 12, layout="lane")
    want = kernels.plain["level2_select"](s, 12, "lane")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert set(kernels.launches.values()) == {0}
    program = tracer.export()
    [c] = program["counters"]
    assert {k: c[k] for k in ("name", "B", "W", "rounds", "layout", "body")} == dict(
        name="level2_select", B=4, W=5000, rounds=12, layout="lane", body="plain")
    [span] = program["spans"]
    assert span["name"] == "batch/select" and c["span"] == span["id"]
    for bad in (dict(rounds=0), dict(rounds=129), dict(rounds=8, layout="lanes")):
        with pytest.raises(ValueError):
            kernels.level2_select(s, **bad)
    with pytest.raises(TypeError):
        kernels.level2_select(s.double(), 8)


def test_ladder_rows_are_the_suspects_it_was_given(setup, monkeypatch):
    _, eng, qs = setup
    given = []
    ladder = partitioned.rerun_suspect_ladder

    def recorded(suspects, *args, **kw):
        given.append(np.flatnonzero(suspects))
        return ladder(suspects, *args, **kw)

    monkeypatch.setattr(partitioned, "rerun_suspect_ladder", recorded)
    _, program = _traced(eng, qs)
    lad = eng.last_ladder
    assert lad["suspects"] > 0 and len(given) == 1
    assert lad["rows"] == given[0].tolist() and all(type(r) is int for r in lad["rows"])
    assert lad["rows"] == sorted(lad["rows"]) and len(lad["rows"]) == lad["suspects"]
    # the active tracer counts them, under the ladder's span
    counted = [c for c in program["counters"] if c["name"] == "ladder_suspects"]
    spans = {s["id"]: s for s in program["spans"]}
    assert [c["rows"] for c in counted] == [lad["rows"]]
    assert spans[counted[0]["span"]]["name"] == "search/rerun"
    # no suspects: an empty list all the same
    exact = get_engine("partitioned")(setup[0], device="cpu", db_tile=512, query_batch=32,
                                      certified=False)
    exact.search(_rows(qs, slice(8)))
    assert exact.last_ladder == dict(suspects=0, rows=[])


def test_a_span_and_a_record_function_range_agree_on_the_cpu():
    """The spans' clock is the profiler's: a span and a ``record_function``
    range around the same block agree to within 1 ms at the median (the
    first block, which pays the profiler's first range, left out), and
    every one to within 50 ms, where another clock would be off by years
    or by the machine's uptime."""
    tracer = PhaseTimer("cpu", fence=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording(tracer):
        for i in range(51):
            with record_function(f"block{i}"), maybe_phase(None, f"block{i}"):
                torch.ones(1000).sum()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = {e.name: e.time_range for e in prof.events() if e.name.startswith("block")}
    spans = tracer.export()["spans"][1:]
    assert len(spans) == len(ranges) - 1 == 50
    gaps = [abs(t0 + ranges[s["name"]].start * 1e3 - s["start_ns"]) for s in spans]
    gaps += [abs(t0 + ranges[s["name"]].end * 1e3 - s["end_ns"]) for s in spans]
    assert float(np.median(gaps)) < 1e6 and max(gaps) < 5e7


def test_maybe_phase_feeds_the_timer_and_the_tracer_once_each():
    class Names:
        """A phase recorder that takes names alone."""

        def __init__(self):
            self.names = []

        def phase(self, name):
            self.names.append(name)
            return contextlib.nullcontext()

    tracer, fenced, names = PhaseTimer("cpu", fence=False), PhaseTimer("cpu"), Names()
    with maybe_phase(fenced, "a", queries=3):
        pass
    # a fenced timer keeps its totals alone: no span, no counter
    fenced.count("hit", n=1)
    assert fenced.as_dict()["a"]["n"] == 1 and fenced.spans == fenced.counters == []
    with recording(tracer):
        with maybe_phase(tracer, "b"):          # the active tracer itself: once
            with maybe_phase(names, "c", queries=4):
                tracer.count("hit", n=1)
    assert [s["name"] for s in tracer.spans] == ["b", "c"] and names.names == ["c"]
    assert tracer.spans[1]["queries"] == 4 and tracer.spans[1]["parent"] == 0
    assert tracer.counters[0]["span"] == 1 and tracer.counters[0]["n"] == 1
    assert timing.active_tracer is None
    out = tracer.export()
    assert out["clock"] == "time.time_ns" and "device_ms" not in out["spans"][0]


def test_cli_profile_puts_the_search_span_around_its_aten_ops(tmp_path):
    from hvq_tpu_torch.cli.main import main

    ds = generate_dataset(3000, seed=40, categories=20)
    qs = generate_queries(20, seed=41, categories=20)
    formats.write_data_bin(tmp_path / "data.bin", ds)
    formats.write_query_bin(tmp_path / "queries.bin", qs)
    rc = main(["run", "--data", str(tmp_path / "data.bin"),
               "--queries", str(tmp_path / "queries.bin"), "--engine", "partitioned",
               "--output", str(tmp_path / "out.bin"), "--device", "cpu",
               "--query-batch", "8", "--db-tile", "512", "--profile", str(tmp_path / "prof")])
    assert rc == 0
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("pid") == profiling.SPAN_PID and e["ph"] == "X"]
    search = [e for e in spans if e["name"] == "search"]
    assert len(search) == 1 and search[0]["args"]["queries"] == qs.m
    assert {"search/route", "search/fetch"} <= {e["name"] for e in spans}
    lo, hi = search[0]["ts"], search[0]["ts"] + search[0]["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops and all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in ops)
    counters = {e["name"] for e in events if e.get("pid") == profiling.SPAN_PID and e["ph"] == "i"}
    assert {"k1_launch", "route"} <= counters <= {"k1_launch", "ladder_suspects",
                                                  "level2_select", "route", "pack"}


@pytest.mark.parametrize("engine", ["partitioned", "partitioned_sharded"])
def test_cli_profile_counts_the_native_router_by_query_type(tmp_path, engine):
    """``run --profile``: one ``route`` counter under ``search/route``
    whose counts are the file's query types (table: types 1 and 3,
    segment: type 3, time: type 2), and a ``pack`` counter under each
    ``routed/pack`` span, whose queries are routed ones of types 1–3,
    packed into at least queries ÷ route_group groups, one layout or more."""
    from hvq_tpu_torch.cli.main import main

    ds = generate_dataset(6000, seed=44, categories=20)
    qs = generate_queries(120, seed=45, categories=20)
    formats.write_data_bin(tmp_path / "data.bin", ds)
    formats.write_query_bin(tmp_path / "queries.bin", qs)
    rc = main(["run", "--data", str(tmp_path / "data.bin"),
               "--queries", str(tmp_path / "queries.bin"), "--engine", engine,
               "--output", str(tmp_path / "out.bin"), "--device", "cpu",
               "--query-batch", "16", "--db-tile", "512", "--profile", str(tmp_path / "prof")])
    assert rc == 0
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    mine = [e for e in events if e.get("pid") == profiling.SPAN_PID]
    by_id = {e["args"]["id"]: e for e in mine if e["ph"] == "X"}
    counted = lambda name: [e["args"] for e in mine if e["ph"] == "i" and e["name"] == name]
    n = Counter(qs.qtype.tolist())
    (route,) = counted("route")
    assert by_id[route["span"]]["name"] == "search/route"
    assert (route["queries"], route["table"], route["segment"], route["time"]) == (
        qs.m, n[1] + n[3], n[3], n[2])
    packs = counted("pack")
    assert packs and all(by_id[c["span"]]["name"] == "routed/pack" for c in packs)
    assert 0 < sum(c["queries"] for c in packs) <= n[1] + n[2] + n[3]
    assert all(c["groups"] * 16 >= c["queries"] > 0 and c["layouts"] >= 1 for c in packs)


def test_cli_profile_carries_the_mesh_spans(tmp_path):
    """``run --engine partitioned_sharded --profile`` (one CPU shard): the
    time view's ``mesh/place`` span, a ``mesh_window`` counter under
    ``search/window`` and a ``mesh/window`` span around each windowed
    batch's ``mesh/merge``."""
    from hvq_tpu_torch.cli.main import main

    ds = generate_dataset(32768, seed=42, categories=20)
    qs = generate_queries(128, seed=43, categories=20, types=(2,))
    formats.write_data_bin(tmp_path / "data.bin", ds)
    formats.write_query_bin(tmp_path / "queries.bin", qs)
    rc = main(["run", "--data", str(tmp_path / "data.bin"),
               "--queries", str(tmp_path / "queries.bin"), "--engine", "partitioned_sharded",
               "--output", str(tmp_path / "out.bin"), "--device", "cpu",
               "--query-batch", "32", "--db-tile", "2048",
               "--engine-opt", "time_view_min_queries=1", "--profile", str(tmp_path / "prof")])
    assert rc == 0
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    mine = [e for e in events if e.get("pid") == profiling.SPAN_PID]
    spans = [e for e in mine if e["ph"] == "X"]
    by_id = {e["args"]["id"]: e for e in spans}
    place = [e for e in spans if e["name"] == "mesh/place"]
    assert [e["args"]["view"] for e in place] == ["time"]
    assert place[0]["args"]["card"] == "cpu" and place[0]["args"]["rows"] == 32768
    assert place[0]["args"]["bytes"] == 32768 * (128 * 4 + 16)
    windows = [e for e in mine if e["ph"] == "i" and e["name"] == "mesh_window"]
    assert windows and all(by_id[e["args"]["span"]]["name"] == "search/window"
                           for e in windows)
    assert {"B", "row0", "ntw", "local_tiles"} <= set(windows[0]["args"])
    mesh_window = [e for e in spans if e["name"] == "mesh/window"]
    assert len(mesh_window) == len(windows)
    merges = [e for e in spans if e["name"] == "mesh/merge"]
    assert sum(by_id[e["args"]["parent"]]["name"] == "mesh/window"
               for e in merges) == len(windows)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _syncs(prof) -> int:
    return sum(1 for e in prof.events()
               if "Synchronize" in e.name or e.name in ("cudaMemcpy", "cudaFree"))


@pytest.mark.cuda
def test_the_tracer_adds_no_synchronisation_on_the_card(cuda):
    ds = generate_dataset(100_000, seed=1, categories=30)
    eng = get_engine("partitioned")(ds, device=cuda, route_buckets=(4096,),
                                    time_view_min_queries=1)
    qs = _queries(ds, m=2048)
    eng.search(qs)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as off:
        ids_off, _ = eng.search(qs)
    tracer = PhaseTimer(cuda, fence=False)
    with profile(activities=acts) as on, recording(tracer):
        ids_on, _ = eng.search(qs)
    np.testing.assert_array_equal(ids_off, ids_on)
    assert _syncs(on) == _syncs(off) > 0
    torch.cuda.synchronize()
    spans = tracer.export()["spans"]
    assert spans and all(s["device_ms"] >= 0 for s in spans)
    assert {"search", "routed/pack", "batch/select"} <= {s["name"] for s in spans}
