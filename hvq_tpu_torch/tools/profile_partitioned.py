"""Device busy share and kernel split of one partitioned search on the card.

    python -m hvq_tpu_torch.tools.profile_partitioned
        [--out chiprun_out/profile_partitioned.json]

Builds chip_smoke.py's phase-7 configuration from ``tools.workload``
(10⁷ rows, bf16 scan plane, 4·10⁴ mixed queries), runs one warm-up
search (it builds the time view), then traces one unfenced search with
``torch.profiler``: wall time, the device time as the union of its
kernel and copy intervals (busy), the busy share, the idle gaps between
device work, and the kernels ranked by device time. Prints one JSON
object and writes it to ``--out``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from hvq_tpu_torch import get_engine
from hvq_tpu_torch.tools import workload


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the profile runs only on a GPU")
    ds, qs = workload.mixed(workload.PARTITIONED_ROWS, workload.PARTITIONED_SEED)
    qs = workload.partitioned_queries(qs)
    eng = get_engine("partitioned")(ds, scan_store="bf16")
    eng.search(qs)                                   # warm-up: the time view
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.search(qs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                 if getattr(e, "device_type", None) == cuda)
    # busy = the union of device intervals; idle gaps between them
    busy_us, gaps, end = 0.0, [], None
    for a, b in dev:
        if end is not None and a > end:
            gaps.append(a - end)
        busy_us += max(0.0, b - max(a, end if end is not None else a))
        end = b if end is None else max(end, b)
    busy_ms = busy_us / 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if getattr(e, "device_type", None) == cuda),
                     key=_device_us, reverse=True)
    return dict(
        device=torch.cuda.get_device_name(0), rows=ds.n, queries=qs.m,
        wall_ms=wall_ms, busy_ms=busy_ms, busy_share=busy_ms / wall_ms,
        device_span_ms=(dev[-1][1] - dev[0][0]) / 1e3 if dev else None,
        idle_gap_ms=sum(gaps) / 1e3, largest_gaps_ms=sorted(
            (g / 1e3 for g in gaps), reverse=True)[:5],
        ladder=dict(eng.last_route["ladder"]),
        top_kernels=[dict(name=e.key[:120], ms=_device_us(e) / 1e3, calls=e.count,
                          share_of_busy=_device_us(e) / 1e3 / busy_ms)
                     for e in kernels[:15]],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile_partitioned.json")
    args = ap.parse_args(argv)
    res = profile()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
