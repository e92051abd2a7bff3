"""Phase timers: the counterpart of ``hvq_tpu.utils.timing``.

PyTorch returns before a CUDA device finishes, so an unfenced host clock
measures the enqueue. A :class:`PhaseTimer` built for a CUDA device
synchronises it at the end of every phase; the fence perturbs the
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
