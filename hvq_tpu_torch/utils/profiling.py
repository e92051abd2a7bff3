"""Profiler integration: the counterpart of ``hvq_tpu.utils.profiling``.

* ``trace(dir, device)``: a ``torch.profiler`` trace (CPU ops, and CUDA
  kernels when a card is present) around a block, exported as a Chrome
  trace into ``dir`` (viewable in Perfetto or ``chrome://tracing``), with
  the program's spans and counters (``utils.timing``) on a track of their
  own, on the trace's timebase;
* ``device_memory_stats()``: ``torch.cuda.memory_stats`` of a card, the
  analogue of the reference's optional MEM_TRACK counter (util.h:74-97).

Host hardware counters (cycles, instructions, cache and branch misses, the
task clock) come from ``hvq_tpu_torch.native.PerfCounters``, the port's
``perf_event_open`` wrapper; the CLI's ``run`` brackets the search in them.
"""

from __future__ import annotations

import contextlib
import json
import os

import torch

from hvq_tpu_torch.utils import timing

# The spans' track in a trace: a process id that no process or device of
# the profile has (the profiler numbers devices from 0, processes by pid).
SPAN_PID = 1 << 30


@contextlib.contextmanager
def trace(log_dir: str, device="cpu"):
    """Capture a ``torch.profiler`` trace around a block; the Chrome trace
    lands in ``log_dir/trace.json``. The block runs under
    ``timing.recording`` of an unfenced ``PhaseTimer`` on ``device``,
    whose spans and counters join the trace on a track of their own."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    tracer = timing.PhaseTimer(device, fence=False)
    with profile(activities=acts) as prof:
        with timing.recording(tracer):
            yield prof
        if tracer.device.type == "cuda":
            torch.cuda.synchronize(tracer.device)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, tracer.export())


def _add_spans(path: str, program: dict) -> None:
    """Write the spans of ``program`` (``PhaseTimer.export()``) into the
    Chrome trace at ``path`` as complete (``X``) events, and its counters
    as instant events, on the track ``SPAN_PID``: the trace's ``ts`` is
    microseconds since its ``baseTimeNanoseconds`` on the spans' clock."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    events = doc["traceEvents"]
    events += [
        dict(ph="M", name="process_name", pid=SPAN_PID, tid=0,
             args=dict(name="hvq_tpu_torch spans")),
        dict(ph="M", name="process_sort_index", pid=SPAN_PID, tid=0,
             args=dict(sort_index=-1)),
    ]
    for span in program["spans"]:
        args = {k: v for k, v in span.items() if k not in ("name", "start_ns", "end_ns")}
        events.append(dict(ph="X", cat="program_span", name=span["name"], pid=SPAN_PID,
                           tid=0, ts=(span["start_ns"] - base) / 1e3,
                           dur=(span["end_ns"] - span["start_ns"]) / 1e3, args=args))
    for c in program["counters"]:
        args = {k: v for k, v in c.items() if k not in ("name", "t_ns")}
        events.append(dict(ph="i", s="t", cat="program_counter", name=c["name"],
                           pid=SPAN_PID, tid=0, ts=(c["t_ns"] - base) / 1e3, args=args))
    with open(path, "w") as f:
        json.dump(doc, f)


def device_memory_stats(device=None) -> dict:
    """Live memory statistics of a CUDA device (bytes); ``{}`` for a CPU
    device or without a card."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(dev))
