"""Profiler integration: the counterpart of ``hvq_tpu.utils.profiling``.

* ``trace(dir)``: a ``torch.profiler`` trace (CPU ops, and CUDA kernels
  when a card is present) around a block, exported as a Chrome trace into
  ``dir`` (viewable in Perfetto or ``chrome://tracing``);
* ``cost_analysis(fn, *args)``: the operations ``fn`` runs, counted by
  ``torch.utils.flop_counter.FlopCounterMode``;
* ``device_memory_stats()``: ``torch.cuda.memory_stats`` of a card, the
  analogue of the reference's optional MEM_TRACK counter (util.h:74-97).

Host hardware counters (the JAX package's ``hvq_tpu.native.PerfCounters``)
are not ported yet.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace around a block; the Chrome trace
    lands in ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def cost_analysis(fn, *args, **kwargs) -> dict:
    """``{"flops": n}``: the floating-point operations of ``fn(*args,
    **kwargs)`` as PyTorch's ``FlopCounterMode`` counts them (matmuls,
    convolutions, attention). Unlike the JAX version it runs ``fn`` once and
    has no bytes estimate, and work inside the port's ctypes kernels
    (``ops.kernels``, ``ops.probe_kernels``) is invisible to it."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": int(counter.get_total_flops())}


def device_memory_stats(device=None) -> dict:
    """Live memory statistics of a CUDA device (bytes); ``{}`` for a CPU
    device or without a card."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(dev))


def summarize_bytes(num: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(num) < 1024:
            return f"{num:.2f} {unit}"
        num /= 1024
    return f"{num:.2f} PiB"
