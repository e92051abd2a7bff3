"""Phase timers: the counterpart of ``hvq_tpu.utils.timing``.

The reference instruments with two tiers: rdtsc phase timers
(util.h:16-29) and ``perf_event_open`` hardware counters around the whole
query loop (perfevent.hpp:44-320). In the port they are:

* wall-clock phase timers (this module);
* ``torch.profiler`` traces for a kernel-level breakdown
  (``utils/profiling.py``);
* host hardware counters, ``hvq_tpu_torch.native.PerfCounters``, the same
  counter set as the reference;
* :func:`track_host_memory`, peak host allocation (the reference's
  ``MEM_TRACK``), and :func:`time_fn`, a best-of-n fenced wall time.

PyTorch returns before a CUDA device finishes, so an unfenced host clock
measures the enqueue. A :class:`PhaseTimer` built for a CUDA device
synchronises it at both ends of every phase; the fence perturbs the
pipelining it measures, so pass a timer only when a breakdown is wanted.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


@dataclass
class PhaseTimer:
    """Named accumulating phase timers.

    >>> t = PhaseTimer(device="cuda")
    >>> with t.phase("scan"):
    ...     out = f(x)
    >>> t.report()
    """

    device: torch.device | str = "cpu"
    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    def __post_init__(self):
        self.device = torch.device(self.device)

    def fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a block, fenced on a CUDA device at both ends."""
        self.fence()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.fence()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

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


@contextlib.contextmanager
def maybe_phase(timer: PhaseTimer | None, name: str):
    """``timer.phase(name)`` when a timer is given, else a no-op."""
    if timer is None:
        yield
    else:
        with timer.phase(name):
            yield


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
