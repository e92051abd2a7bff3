"""Serving-shaped latency of the port: p50/p95/p99/max per call at B = 1
and B = 16, on one NVIDIA GPU.

    python -m hvq_tpu_torch.tools.serving_latency [--device cpu]
    SL_N=10000000 SL_CALLS=100 python -m hvq_tpu_torch.tools.serving_latency

The port's copy of the repository's ``experiments/serving_latency.py``:
the host wall of each ``engine.search`` call (ids only) on single queries
and on 16-query micro-batches of one mixed stream, for the dense engine
(``batched``: every call scans all N rows) and the routed one
(``partitioned``: a selective query reads its category partition or time
window), with how many calls took a certificate rerun (the ladder's
extra round trip). Rows from seed 0, queries from seed 11, 1000
categories; the bf16 scan plane from 4·10⁶ rows; ``query_batch=16``; two
warm calls (16 queries, then one) before timing, and ``SL_WARM`` more
untimed calls, one query of each type first at B = 1, on a disjoint part
of the stream.

Knobs: ``SL_N`` (10⁶), ``SL_CALLS`` (200), ``SL_ENGINES``
(``batched,partitioned``), ``SL_WARM`` (0). After each text line it
prints one JSON line with the same numbers, the card's name and power
limit.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np

from hvq_tpu_torch.utils.formats import slice_queries


def percentiles(walls_ms) -> dict:
    """p50, p95, p99 and max of the sorted walls, at the indices
    ``int(p · (len − 1))`` the repository's script uses."""
    w = np.sort(np.asarray(walls_ms, dtype=np.float64))
    at = lambda p: float(w[int(p * (len(w) - 1))])  # noqa: E731
    return {"p50_ms": at(0.50), "p95_ms": at(0.95), "p99_ms": at(0.99),
            "max_ms": float(w[-1])}


def main(device="cuda") -> list[dict]:
    """Run every engine of ``SL_ENGINES`` on ``device`` (the card by
    default; ``"cpu"`` only when asked); returns the JSON records."""
    from hvq_tpu_torch.models.device_db import resolve_device
    from hvq_tpu_torch.models.registry import get_engine
    from hvq_tpu_torch.tools.card import device_line
    from hvq_tpu_torch.utils.generators import generate_dataset, generate_queries

    device = resolve_device(device)
    n = int(os.environ.get("SL_N", 1_000_000))
    calls = int(os.environ.get("SL_CALLS", 200))
    engines = os.environ.get("SL_ENGINES", "batched,partitioned").split(",")
    warm = int(os.environ.get("SL_WARM", 0))
    card = device_line(device)
    ds = generate_dataset(n, seed=0, categories=1000)
    qs = generate_queries(max((calls + warm + 3) * 16, 2048), seed=11, categories=1000,
                          centers_seed=0)
    store = {"scan_store": "bf16"} if n >= 4_000_000 else {}
    records = []
    for name in engines:
        # the serving-shaped batch: a single query pads to 16
        eng = get_engine(name)(ds, device=device, query_batch=16, **store)
        eng.search(slice_queries(qs, 0, 16), return_dists=False)
        eng.search(slice_queries(qs, 0, 1), return_dists=False)
        for B in (1, 16):
            base = 16 * (2 + calls)          # disjoint from the timed stream
            if warm and B == 1:
                # one query of each type: the routed engine plans by type
                for t in range(4):
                    hits = np.flatnonzero(np.asarray(qs.qtype[base:]) == t)
                    if hits.size:
                        i = base + int(hits[0])
                        eng.search(slice_queries(qs, i, i + 1), return_dists=False)
            for w in range(warm):
                i = base + w if B == 1 else base + 16 * w
                eng.search(slice_queries(qs, i, i + B), return_dists=False)
            walls, reruns = [], 0
            for c in range(calls):
                i = 16 + c if B == 1 else 16 * (1 + c)
                q1 = slice_queries(qs, i, i + B)
                t0 = time.perf_counter()
                eng.search(q1, return_dists=False)
                walls.append(1e3 * (time.perf_counter() - t0))
                # a certificate that failed sends the call down the ladder
                reruns += eng.last_ladder.get("suspects", 0) > 0
            p = percentiles(walls)
            print(f"{name:12s} N={n} B={B:2d}: p50 {p['p50_ms']:7.2f} | "
                  f"p95 {p['p95_ms']:7.2f} | p99 {p['p99_ms']:7.2f} | "
                  f"max {p['max_ms']:7.2f} ms | rerun calls {reruns}/{len(walls)}",
                  flush=True)
            rec = dict(tool="serving_latency", backend="torch", engine=name, n=n,
                       batch=B, calls=len(walls), **p, rerun_calls=reruns, device=card)
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del eng
        gc.collect()
    return records


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(argv[argv.index("--device") + 1] if "--device" in argv else "cuda")
