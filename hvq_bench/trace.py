"""What a run records of the program: phase spans through the engines'
``phases=`` hook, K1's launch shapes, the rerun ladder's suspects, and the
profiler's device intervals.

Everything here wraps or listens; nothing changes what the program
computes.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from hvq_bench import stats
from hvq_bench.cards import synchronize

# K1 on the device, by the names its two bodies compile to
# (csrc/packed_scan_v3.cu: the tensor-core body in the Axis1 layout, and
# the CUDA-core body)
K1_KERNELS = (("scan_wgmma", "Axis1"), ("k1_simt",))


def is_k1(name: str) -> bool:
    return any(all(part in name for part in parts) for parts in K1_KERNELS)


class Recorder:
    """A phase recorder for the engines' ``phases=`` hook (``maybe_phase``
    calls ``phases.phase(name)``): accumulates wall seconds and counts per
    name and opens ``torch.profiler.record_function(name)``, so the
    profile's idle gaps carry the host phase's name. ``fence=True``
    synchronises each of ``cards`` (the cell's CUDA devices) at both ends
    of a phase, as the program's ``PhaseTimer`` does its one device, so a
    fenced span holds all the work it enqueued on any card;
    ``fence=False`` only names the phases."""

    def __init__(self, cards, fence: bool = True):
        self.cards = list(cards) if fence else []
        self.seconds: dict = defaultdict(float)
        self.counts: dict = defaultdict(int)

    def _sync(self):
        synchronize(self.cards)

    @contextlib.contextmanager
    def phase(self, name: str):
        with torch.profiler.record_function(name):
            self._sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._sync()
                self.seconds[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def spans(self) -> dict:
        return {name: {"s": self.seconds[name], "n": self.counts[name]}
                for name in sorted(self.seconds)}


@contextlib.contextmanager
def patched(module, attr: str, wrapper):
    """``module.attr`` replaced by ``wrapper(original)`` inside the block."""
    original = getattr(module, attr)
    setattr(module, attr, wrapper(original))
    try:
        yield
    finally:
        setattr(module, attr, original)


@contextlib.contextmanager
def k1_launches(out: list):
    """Record each K1 launch's shape in ``out`` (dicts of B, rows, W and
    plane_bytes, from the launch's own arguments and output), by wrapping
    the module attribute ``hvq_tpu_torch.ops.kernels.packed_scan_v3``
    through which the engines launch it."""
    from hvq_tpu_torch.ops import kernels

    def wrapper(k1):
        def packed_scan_v3(Vs, *args, **kw):
            res = k1(Vs, *args, **kw)
            db_tile = kw.get("db_tile", 16384)
            rows = kw["ntw"] * db_tile if kw.get("ntw") else Vs.shape[0]
            out.append(dict(B=int(args[4].shape[0]), rows=int(rows),
                            W=int(res[0].shape[1]), plane_bytes=Vs.element_size()))
            return res
        return packed_scan_v3

    with patched(kernels, "packed_scan_v3", wrapper):
        yield


@contextlib.contextmanager
def ladder_suspects(out: list):
    """Append the query indices of each rerun ladder's suspects to ``out``
    (one array a ladder run), by wrapping ``rerun_suspect_ladder`` where
    the program's modules call it from. Indices are rows of the call's
    query set; a batched engine's padded rows are dropped by the caller."""
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("hvq_tpu_torch.") and m is not None
            and callable(getattr(m, "rerun_suspect_ladder", None))]

    def wrapper(ladder):
        def rerun_suspect_ladder(suspects, *args, **kw):
            out.append(np.flatnonzero(suspects))
            return ladder(suspects, *args, **kw)
        return rerun_suspect_ladder

    with contextlib.ExitStack() as stack:
        for m in mods:
            stack.enter_context(patched(m, "rerun_suspect_ladder", wrapper))
        yield


def _device_events(events, annotations: set):
    """The device's work: kernels, copies and sets. The profiler also puts
    each ``record_function`` range on the device's timeline (a user
    annotation), which is no work of the device."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in events if getattr(e, "device_type", None) == cuda
            and not getattr(e, "is_user_annotation", False)
            and e.name not in annotations
            and "annotation" not in str(getattr(e, "activity_type", ""))]


def _name_gaps(gaps, cpu_events, phases: set, top: int = 200) -> dict:
    """Idle seconds by what the host had open: the longest ``top`` gaps,
    each named by the innermost recorder phase and the innermost host op
    open at its midpoint (main thread), summed by name."""
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    mids = sorted(((a + b) / 2, b - a) for a, b in longest)
    evs = sorted(cpu_events, key=lambda e: (e.time_range.start, -e.time_range.end))
    stack, ei, named = [], 0, defaultdict(float)
    for mid, length in mids:
        while ei < len(evs) and evs[ei].time_range.start <= mid:
            while stack and stack[-1].time_range.end < evs[ei].time_range.start:
                stack.pop()
            stack.append(evs[ei])
            ei += 1
        while stack and stack[-1].time_range.end < mid:
            stack.pop()
        phase = next((e.name for e in reversed(stack) if e.name in phases), None)
        op = stack[-1].name if stack else "host"
        name = op if phase in (None, op) else f"{phase} > {op}"
        named[name] += length / 1e6
    return dict(named)


def read_profile(prof, window_name: str, phases: set, cards) -> dict:
    """The profiled part's record: its wall (the ``window_name`` range),
    the device's busy seconds (the union of kernel, copy and set
    intervals over every card) and each card's (``busy_s_by_card``: the
    union of the intervals on each device index of ``cards``, in order),
    its idle gaps by host activity, device time by kernel name and K1's
    device seconds and launches."""
    events = prof.events()
    win = next((e for e in events if e.name == window_name), None)
    if win is None:
        raise RuntimeError(f"no {window_name!r} range in the profile")
    lo, hi = win.time_range.start, win.time_range.end
    dev = _device_events(events, phases | {window_name})
    busy_us, gaps = stats.busy_union(
        [(e.time_range.start, e.time_range.end) for e in dev], lo, hi)
    by_card = stats.busy_by_card(
        [(e.time_range.start, e.time_range.end, e.device_index) for e in dev], lo, hi, cards)
    thread = win.thread
    cpu = [e for e in events if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA
           and e.thread == thread and e.name != window_name]
    by_name: dict = defaultdict(float)
    k1_us, k1_n = 0.0, 0
    for e in dev:
        d = e.time_range.end - e.time_range.start
        by_name[e.name] += d / 1e6
        if is_k1(e.name):
            k1_us += d
            k1_n += 1
    return dict(
        window_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6,
        busy_s_by_card=[us / 1e6 for us in by_card],
        device_events=len(dev),
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1]),
        idle_gaps=sorted(_name_gaps(gaps, cpu, phases).items(), key=lambda kv: -kv[1]),
        k1_device_s=k1_us / 1e6, k1_kernels=k1_n,
    )
