"""One run of one cell: set-up, the measured window (or the traced parts),
the check of what the timed calls returned, and the metrics.

The window drives one engine of the port, built through
``hvq_tpu_torch.models.registry.get_engine(<config's engine>)`` on the
cell's rows; a timed call is ``engine.search(queries, k=k,
sample_proportion=..., return_dists=False)``, the contest's ids-only
contract, timed from its start to its return, which holds the host copy
of the ids. One client, closed loop: the next call starts when the last
returned, until the window's seconds have passed; the window ends with
the last call.

On the card a run covers the cell's own cards, ``cuda:0`` … of those
visible (``cards.py``; ``run.py`` shows the process no others): each
card's peak memory is reset before set-up and read after the window, and
the run's synchronisations and fenced spans wait for every card.

``run`` works on any device; ``run.py`` is the command, which asks for
the card.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from hvq_bench import cards as cell_cards
from hvq_bench import spec, trace, traffic
from hvq_bench.spec import Cell

# the profiler range around a traced run's profiled part
WINDOW = "hvq_bench/profiled"


def _queryset(q: dict, sl):
    from hvq_tpu_torch.utils.formats import QuerySet
    return QuerySet(qtype=q["qtype"][sl], v=q["v"][sl], l=q["l"][sl],
                    r=q["r"][sl], V=q["V"][sl])


def _dataset(C, T, V):
    from hvq_tpu_torch.utils.formats import Dataset
    return Dataset(C=C.cpu().numpy(), T=T.cpu().numpy(), V=V.cpu().numpy())


def program_engine(cfg: dict, ds, device):
    """The system under test: the configuration's engine of the port."""
    from hvq_tpu_torch.models.registry import get_engine
    return get_engine(cfg["engine"])(ds, device=device, **cfg["keywords"])


class Calls:
    """What the timed calls returned, call by call."""

    def __init__(self):
        self.index, self.walls, self.ids, self.suspects, self.rerun_rows = [], [], [], [], []

    def queries(self, tr: dict) -> int:
        return len(self.index) * int(tr["call_queries"])


def _call(eng, q, tr, cfg, i, calls: Calls | None, ladder_log: list, phases=None):
    """Call ``i`` of the pool: one timed ``engine.search``."""
    sl = traffic.call_slice(tr, i)
    qs = _queryset(q, sl)
    kw = {} if phases is None else {"phases": phases}
    logged = len(ladder_log)
    t0 = time.perf_counter()
    ids, _ = eng.search(qs, k=int(cfg["k"]), sample_proportion=cfg["sample_proportion"],
                        return_dists=False, **kw)
    t1 = time.perf_counter()
    if calls is not None:
        m = sl.stop - sl.start
        calls.index.append(i)
        calls.walls.append(t1 - t0)
        calls.ids.append(ids)
        calls.suspects.append(int(getattr(eng, "last_ladder", {}).get("suspects", 0)))
        rows = [a[a < m] for a in ladder_log[logged:]]
        calls.rerun_rows.append(np.unique(np.concatenate(rows)) if rows else
                                np.zeros(0, np.int64))
    return t1


def _sample(calls: Calls, ok: list, q: dict, tr: dict, seed: int):
    """(call positions, rows) of the answers the check judges, among the
    calls ``ok``: the same number of each type drawn from the seed over
    every answer, then at most ``check_reruns`` answers of the rerun
    ladder."""
    rng = np.random.default_rng(traffic.stream_seed(seed, 2))
    m = int(tr["call_queries"])
    pos = np.repeat(np.asarray(ok, np.int64), m)
    rows = np.tile(np.arange(m), len(ok))
    qtype = np.concatenate([q["qtype"][traffic.call_slice(tr, calls.index[j])] for j in ok])
    types = np.unique(qtype)
    per = max(1, int(tr["check_queries"]) // len(types))
    pick = [rng.choice(np.flatnonzero(qtype == t), min(per, int((qtype == t).sum())),
                       replace=False) for t in types]
    reruns = np.concatenate([c * m + calls.rerun_rows[j] for c, j in enumerate(ok)]
                            + [np.zeros(0, np.int64)]).astype(np.int64)
    if reruns.size > int(tr["check_reruns"]):
        reruns = rng.choice(reruns, int(tr["check_reruns"]), replace=False)
    chosen = np.unique(np.concatenate(pick + [reruns]))
    return pos[chosen], rows[chosen], int(reruns.size)


def check(cell: Cell, seed: int, calls: Calls, q: dict, device) -> dict:
    """Judge the sampled answers of ``calls`` against the plain reference
    on the database generated anew from the seed: {name: (value, limit)},
    the answers judged and those that failed."""
    cfg, tr = cell.config, cell.traffic
    judge = spec.load_module("checks", cfg["check"])
    lim = judge.limits(cfg)
    m = int(tr["call_queries"])
    ok = [j for j, ids in enumerate(calls.ids)
          if getattr(ids, "shape", None) == (m, int(cfg["k"]))]
    missing = len(calls.ids) - len(ok)
    numbers = {"dist_gap": 0.0, "bad_ids": 0, "dup_ids": 0, "missing": missing}
    failed, judged, reruns = missing * m, 0, 0
    if ok:
        pos, rows, reruns = _sample(calls, ok, q, tr, seed)
        got = np.stack([calls.ids[p][r] for p, r in zip(pos, rows)]).astype(np.int64)
        pool_rows = np.array([traffic.call_slice(tr, calls.index[p]).start + r
                              for p, r in zip(pos, rows)])
        qd = {name: torch.from_numpy(np.ascontiguousarray(a[pool_rows])).to(device)
              for name, a in q.items()}
        gen = spec.load_module("generators", cfg["generator"])
        db = gen.database(cfg, seed, device)
        res = judge.judge(cfg, db, qd, torch.from_numpy(got).to(device))
        del db
        failed += res.pop("failed")
        numbers.update(res)
        judged = int(pos.size)
    return dict(numbers={name: (numbers[name], lim[name]) for name in lim},
                judged=judged, reruns_judged=reruns, failed=failed)


def _free(cards):
    gc.collect()
    if cards:
        cell_cards.synchronize(cards)
        torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
        t_start: float | None = None, engine=program_engine) -> dict:
    """One run of ``cell``: returns {"correct", "attempted", "failed",
    "record", "check"}, the record being what the metric files read.
    ``engine(cfg, ds, device)`` builds what the window drives (the control
    puts the reference there)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cards = cell_cards.of(device, cell.chips)
    cell_cards.reset_peaks(cards)
    cfg, tr = cell.config, cell.traffic
    traffic.check(tr)
    marks = {}
    gen = spec.load_module("generators", cfg["generator"])
    t = time.perf_counter()
    C, T, V = gen.database(cfg, seed, device)
    ds = _dataset(C, T, V)
    del C, T, V
    q = traffic.pool(cfg, tr, seed, device)
    marks["data_s"] = time.perf_counter() - t
    t = time.perf_counter()
    eng = engine(cfg, ds, device)
    marks["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ladder_log: list = []
    with trace.ladder_suspects(ladder_log):
        for i in range(int(tr["warmup_calls"])):
            _call(eng, q, tr, cfg, i, None, ladder_log)
        first = int(tr["warmup_calls"])
        cell_cards.synchronize(cards)
        marks["warmup_s"] = time.perf_counter() - t
        w0 = time.perf_counter()
        setup_s = w0 - t_start
        calls = Calls()
        if not traced:
            i = first
            while True:
                end = _call(eng, q, tr, cfg, i, calls, ladder_log)
                i += 1
                if end - w0 >= seconds:
                    break
            window_s = end - w0
        else:
            prof_rec, launches = None, []
            named = trace.Recorder(cards, fence=False)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cards:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            n_prof, n_fenced = int(tr["trace_calls"]), int(tr["fenced_calls"])
            with trace.k1_launches(launches), torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(WINDOW):
                    for i in range(first, first + n_prof):
                        _call(eng, q, tr, cfg, i, calls, ladder_log, phases=named)
                    cell_cards.synchronize(cards)
            t = time.perf_counter()
            prof_rec = trace.read_profile(prof, WINDOW, set(named.seconds),
                                          [c.index for c in cards])
            del prof
            marks["profile_read_s"] = time.perf_counter() - t
            # the same calls again without the profiler, which slows the host:
            # the wall that the device's busy time is set against (a second
            # visit of each call, as in the window, where the pool is cycled)
            t = time.perf_counter()
            for i in range(first, first + n_prof):
                _call(eng, q, tr, cfg, i, calls, ladder_log)
            unprofiled_s = time.perf_counter() - t
            fenced = trace.Recorder(cards, fence=True)
            for i in range(first + n_prof, first + n_prof + n_fenced):
                _call(eng, q, tr, cfg, i, calls, ladder_log, phases=fenced)
            window_s = prof_rec["window_s"]
    peaks = cell_cards.peaks(cards)
    last_route = dict(getattr(eng, "last_route", {}) or {})
    del eng
    _free(cards)
    t = time.perf_counter()
    res = check(cell, seed, calls, q, device)
    marks["check_s"] = time.perf_counter() - t
    correct = all(v <= lim for v, lim in res["numbers"].values())
    record = dict(rows=int(cfg["rows"]), chips=cell.chips, setup_s=setup_s, window_s=window_s,
                  calls=len(calls.index), queries=calls.queries(tr), walls_s=calls.walls,
                  files=[i % int(tr["pool_calls"]) for i in calls.index],
                  memory_peak_bytes=max(peaks, default=0), memory_peak_bytes_by_card=peaks,
                  marks=marks, last_route=last_route)
    if traced:
        record.update(
            spans=fenced.spans(), fenced_queries=n_fenced * int(tr["call_queries"]),
            unprofiled_s=unprofiled_s,
            traced_calls=len(calls.index), traced_queries=calls.queries(tr),
            suspects=calls.suspects, profile=prof_rec, k1_launches=launches)
    return dict(correct=correct, attempted=calls.queries(tr), failed=res["failed"],
                record=record, check=res)


def metrics(cell: Cell, record: dict, traced: bool) -> dict:
    """{name: {"value", "unit"}} of the cell's end-to-end metrics, or of
    its per-layer metrics when traced; a reader that finds nothing to read
    leaves its metric out."""
    out = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cell.reader(m).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
