"""What chip_smoke and the tools share about the card: its data-sheet
peaks, its name and power limit, CUDA-event timing and the bound rule."""

from __future__ import annotations

import subprocess

import torch

# H100 SXM data-sheet peaks at 700 W (dense): bf16 tensor cores, fp32 on
# the CUDA cores, int8 tensor cores, HBM3.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12


def require_card() -> torch.device:
    """The CUDA device, or raise: the kernels have no CPU mode."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this runs only on a GPU")
    return torch.device("cuda")


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the current card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def event_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn``: one warm-up, then CUDA events around
    ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(ops: float, peak: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of ``ops`` at
    ``peak`` and ``nbytes`` at the HBM rate, and which of them sets it."""
    ops_ms, bytes_ms = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")
