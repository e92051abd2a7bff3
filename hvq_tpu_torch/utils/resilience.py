"""Failure handling: the counterpart of ``hvq_tpu.utils.resilience``.

An engine wrapper with two cheap protections:

* **transient-error retry**: bounded retries with exponential backoff for
  errors whose text carries a transient marker (``_TRANSIENT_MARKERS``);
* **OOM bisection**: an out-of-memory error on a large query set splits
  the set in two and recurses, so one oversized request fails soft.

Results are reassembled in the original query order; the semantics are
the wrapped engine's.

Classification is textual, as in the JAX package, except that
``torch.cuda.OutOfMemoryError`` and ``MemoryError`` are out-of-memory by
type. Which CUDA errors count as transient: only those whose text carries
a marker, e.g. cuBLAS's ``CUBLAS_STATUS_INTERNAL_ERROR`` ("INTERNAL") or
a collective's "UNAVAILABLE". A sticky CUDA error (an illegal address, a
launch failure, an ECC error) carries none and is raised at once: it
leaves the process's CUDA context unusable, so a retry in the same
process cannot succeed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hvq_tpu_torch import constants as _c
from hvq_tpu_torch.utils.formats import QuerySet, slice_queries

_TRANSIENT_MARKERS = ("DEADLINE_EXCEEDED", "UNAVAILABLE", "INTERNAL", "ABORTED")


class ResilientEngine:
    """Wraps any engine with retry + OOM-bisection semantics."""

    def __init__(self, engine, max_retries: int = 3, backoff_s: float = 1.0,
                 min_split: int = 1):
        self.engine = engine
        self.name = f"resilient({getattr(engine, 'name', '?')})"
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.min_split = min_split

    def __getattr__(self, item):
        # transparent attribute proxy (query_batch, window_rows, ...)
        return getattr(self.engine, item)

    def search(self, qs: QuerySet, k: int = _c.K_DEFAULT,
               sample_proportion: float = 1.0, **kwargs):
        return self._search_range(qs, k, sample_proportion, kwargs)

    def _search_range(self, qs: QuerySet, k: int, sp: float, kwargs):
        try:
            return self._with_retries(qs, k, sp, kwargs)
        except Exception as e:  # noqa: BLE001 — classified below
            if not _is_oom(e) or qs.m <= self.min_split:
                raise
            mid = qs.m // 2
            ids_a, d_a = self._search_range(slice_queries(qs, 0, mid), k, sp, kwargs)
            ids_b, d_b = self._search_range(slice_queries(qs, mid, qs.m), k, sp, kwargs)
            return (
                np.concatenate([ids_a, ids_b]),
                None if d_a is None else np.concatenate([d_a, d_b]),
            )

    def _with_retries(self, qs: QuerySet, k: int, sp: float, kwargs):
        attempt = 0
        while True:
            try:
                return self.engine.search(qs, k=k, sample_proportion=sp, **kwargs)
            except Exception as e:  # noqa: BLE001 — classified below
                if _is_oom(e) or not _is_transient(e):
                    raise
                attempt += 1
                if attempt > self.max_retries:
                    raise
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))


def _error_text(e: BaseException) -> str:
    """Uppercased exception text with its args and chained causes."""
    parts = []
    seen = 0
    while e is not None and seen < 4:
        parts.append(str(e))
        parts.extend(str(a) for a in getattr(e, "args", ()))
        e = getattr(e, "__cause__", None) or getattr(e, "__context__", None)
        seen += 1
    return " ".join(parts).upper()


def _is_oom(e: BaseException) -> bool:
    if isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    t = _error_text(e)
    return "RESOURCE_EXHAUSTED" in t or "OUT OF MEMORY" in t


def _is_transient(e: BaseException) -> bool:
    t = _error_text(e)
    return any(m in t for m in _TRANSIENT_MARKERS)
