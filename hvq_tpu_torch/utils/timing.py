"""Phase timers and the program's spans: the counterpart of
``hvq_tpu.utils.timing``.

The reference instruments with two tiers: rdtsc phase timers
(util.h:16-29) and ``perf_event_open`` hardware counters around the whole
query loop (perfevent.hpp:44-320). In the port they are:

* phase timers and spans (this module);
* ``torch.profiler`` traces for a kernel-level breakdown
  (``utils/profiling.py``), which carry the spans on a track of their own;
* host hardware counters, ``hvq_tpu_torch.native.PerfCounters``, the same
  counter set as the reference;
* :func:`track_host_memory`, peak host allocation (the reference's
  ``MEM_TRACK``), and :func:`time_fn`, a best-of-n fenced wall time.

The engines open their phases with :func:`maybe_phase`, which feeds the
``phases=`` timer a caller passes and the tracer that :func:`recording`
made active. PyTorch returns before a CUDA device finishes, so an unfenced
host clock measures the enqueue. A fenced :class:`PhaseTimer` (the default)
synchronises a CUDA device at both ends of every phase; the fence perturbs
the pipelining it measures. An unfenced one never synchronises: it records
a pair of CUDA events around each span, whose elapsed time is the span's
device time.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


# The handle of a device's current stream, read without building a
# torch.cuda.Stream object (a kernel launch in ``ops.kernels``, a span's
# event here): torch._C._cuda_getCurrentRawStream(index) returns it as an
# int, the call PyTorch's own generated kernels launch with (inductor's
# get_raw_stream). A build without it goes through
# torch.cuda.current_stream(index).cuda_stream, which builds one.
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)
# The current device's index (torch.cuda.current_device() without its
# initialisation check: a CUDA tensor exists, so CUDA is initialised).
current_device = getattr(torch._C, "_cuda_getDevice", None) or torch.cuda.current_device


def clock_ns() -> int:
    """Nanoseconds on the clock that ``torch.profiler`` stamps its host
    events with (Unix time): ``prof.profiler.kineto_results.trace_start_ns()``
    plus an event's microseconds lands on the same axis as a span's."""
    return time.time_ns()


@dataclass
class PhaseTimer:
    """Named accumulating phase timers and, unfenced, the spans and
    counters of the blocks they timed.

    >>> t = PhaseTimer(device="cuda")
    >>> with t.phase("scan"):
    ...     out = f(x)
    >>> t.report()

    ``fence=True`` synchronises a CUDA device at both ends of a phase, so
    ``totals`` hold the device's time too, and keeps nothing else.
    ``fence=False`` never synchronises and keeps each block as a span: its
    name, its own id, its parent's id, its call's id (its outermost span's,
    the request span ``search``), its host start and end in ns on
    :func:`clock_ns`, the fields it was opened with and, on a CUDA device,
    a pair of ``torch.cuda.Event`` recorded on the current stream, resolved
    by :meth:`export` once the caller has synchronised. :meth:`count`
    records a counter under the span that is open.
    """

    device: torch.device | str = "cpu"
    fence: bool = True
    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    spans: list = field(default_factory=list)
    counters: list = field(default_factory=list)
    _open: list = field(default_factory=list, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device)
        self._events = not self.fence and self.device.type == "cuda"
        self._stream = None     # the current stream, while its handle holds

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _event(self):
        """A timing event recorded on the device's current stream (the
        stream object is built again only when the handle changes)."""
        index = self.device.index if self.device.index is not None else current_device()
        if self._stream is None or self._stream.cuda_stream != raw_stream(index):
            self._stream = torch.cuda.current_stream(index)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def phase(self, name: str, **fields):
        """Time a block: fenced on a CUDA device at both ends, or unfenced
        as a span named ``name`` carrying ``fields``."""
        return self._fenced(name) if self.fence else self._span(name, fields)

    @contextlib.contextmanager
    def _fenced(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @contextlib.contextmanager
    def _span(self, name: str, fields: dict):
        up = self._open[-1] if self._open else None
        sid = len(self.spans)
        span = dict(name=name, id=sid, parent=None if up is None else up["id"],
                    call=sid if up is None else up["call"], **fields)
        self.spans.append(span)
        self._open.append(span)
        if self._events:
            span["events"] = [self._event(), None]
        span["start_ns"] = t0 = clock_ns()
        try:
            yield
        finally:
            span["end_ns"] = t1 = clock_ns()
            if self._events:
                span["events"][1] = self._event()
            self._open.pop()
            self.totals[name] += (t1 - t0) / 1e9
            self.counts[name] += 1

    def count(self, name: str, **fields) -> None:
        """A counter ``name`` with ``fields``, under the open span's id
        (unfenced; a fenced timer keeps no counters)."""
        if self.fence:
            return
        up = self._open[-1] if self._open else None
        self.counters.append(dict(
            name=name, span=None if up is None else up["id"],
            call=None if up is None else up["call"], t_ns=clock_ns(), **fields))

    def export(self) -> dict:
        """{"clock", "spans", "counters"}: the closed spans, each with
        ``device_ms``, the elapsed time of its event pair, where it has one,
        and the counters. Call it after synchronising the device."""
        spans = []
        for span in self.spans:
            if "end_ns" not in span:
                continue
            out = {key: v for key, v in span.items() if key != "events"}
            if "events" in span:
                out["device_ms"] = span["events"][0].elapsed_time(span["events"][1])
            spans.append(out)
        return {"clock": "time.time_ns", "spans": spans, "counters": list(self.counters)}

    def add(self, name: str, seconds: float, n: int = 1) -> None:
        self.totals[name] += seconds
        self.counts[name] += n

    def as_dict(self) -> dict:
        """{name: {"ms": total milliseconds, "n": count}}."""
        return {
            name: {"ms": self.totals[name] * 1e3, "n": self.counts[name]}
            for name in sorted(self.totals)
        }

    def report(self, stream=None) -> str:
        """Stderr-style phase dump (cf. optimized.hpp:133-145)."""
        text = "\n".join(
            f"{name}: \t{v['ms']:.3f} ms (n={v['n']})"
            for name, v in self.as_dict().items()
        )
        print(text, file=stream or sys.stderr)
        return text


# The tracer that :func:`recording` made active, or None. Read it as
# ``timing.active_tracer``: it is rebound, so an imported name goes stale.
active_tracer: PhaseTimer | None = None


@contextlib.contextmanager
def recording(timer: PhaseTimer):
    """Make ``timer`` the active tracer inside the block: every
    :func:`maybe_phase` of the program records into it, and K1's launches
    (``ops.kernels.packed_scan_v3``) count into it. One per process."""
    global active_tracer
    before, active_tracer = active_tracer, timer
    try:
        yield timer
    finally:
        active_tracer = before


def _phase(timer, name: str, fields: dict):
    if timer is None:
        return contextlib.nullcontext()
    if isinstance(timer, PhaseTimer):
        return timer.phase(name, **fields)
    return timer.phase(name)


@contextlib.contextmanager
def maybe_phase(timer, name: str, **fields):
    """``timer.phase(name)`` when a timer is given, and the same phase in
    the active tracer when one is on (once if they are the same); else a
    no-op. ``fields`` go to a :class:`PhaseTimer`, not to another phase
    recorder."""
    tracer = active_tracer
    if tracer is timer:
        tracer = None
    if tracer is None and timer is None:
        yield
        return
    with _phase(tracer, name, fields), _phase(timer, name, fields):
        yield


def request_span(search):
    """An engine's ``search(qs, ..., phases=None)`` inside the request
    span ``search`` (:func:`maybe_phase`), which carries the call's query
    count: every phase of the call is its child."""

    @functools.wraps(search)
    def traced(self, qs, *args, **kw):
        with maybe_phase(kw.get("phases"), "search", queries=int(qs.m)):
            return search(self, qs, *args, **kw)

    return traced


@contextlib.contextmanager
def track_host_memory():
    """Peak host allocation inside the block (the reference's ``MEM_TRACK``
    byte counter, util.h:74-97): tracemalloc's (current, peak) bytes in
    the yielded dict's ``current_bytes`` and ``peak_bytes`` after the
    block exits. Card memory: ``utils.profiling.device_memory_stats``."""
    import tracemalloc

    was_tracing = tracemalloc.is_tracing()
    if not was_tracing:
        tracemalloc.start()
    tracemalloc.reset_peak()
    out = {}
    try:
        yield out
    finally:
        out["current_bytes"], out["peak_bytes"] = tracemalloc.get_traced_memory()
        if not was_tracing:
            tracemalloc.stop()


def _fence(result) -> None:
    """Wait for the CUDA devices that hold ``result``'s tensors (nested
    in tuples, lists and dicts); CPU tensors and host values need none."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, (tuple, list)):
        for r in result:
            _fence(r)
    elif isinstance(result, dict):
        for r in result.values():
            _fence(r)


def time_fn(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Best-of-``iters`` wall seconds of ``fn(*args)``, each call fenced on
    the devices of its result's tensors, after ``warmup`` calls."""
    for _ in range(warmup):
        _fence(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        _fence(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best
