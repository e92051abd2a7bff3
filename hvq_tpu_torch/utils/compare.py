"""Differential result comparison — the framework's correctness contract.

Mirrors the reference's verification strategy (src/compare_data.cpp:5-108):
results from two engines are compared by their **recomputed distances** under
an absolute tolerance of 0.002, *not* by ids, because summation-order
differences (SIMD there, tensor-core matmul + reassociation here) legitimately reorder
equidistant or near-tied neighbors (reference optimized.hpp:34-41; the id
comparison exists in the reference but is deliberately commented out,
compare_data.cpp:82-94).

Adds the natural generalization the reference lacks: ``recall_at_k`` against
an exact oracle, the gating metric for approximate modes (BASELINE.json).

The PyTorch port's own copy of ``hvq_tpu.utils.compare``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hvq_tpu_torch import constants as _c


@dataclasses.dataclass
class CompareResult:
    max_abs_diff: float
    num_exceeding: int     # entries with |a-b| > tolerance
    total: int
    status: str            # "same" | "similar" | "different"

    @property
    def ok(self) -> bool:
        return self.status in ("same", "similar")


def compare_distances(
    a: np.ndarray,
    b: np.ndarray,
    tolerance: float = _c.DIST_TOLERANCE,
) -> CompareResult:
    """Element-wise distance comparison (compare_data.cpp:26-77 semantics).

    "same" = bit-identical; "similar" = all within tolerance; "different"
    = at least one entry exceeds it.
    """
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    diff = np.abs(a - b)
    max_diff = float(diff.max()) if diff.size else 0.0
    exceeding = int((diff > tolerance).sum())
    if max_diff == 0.0:
        status = "same"
    elif exceeding == 0:
        status = "similar"
    else:
        status = "different"
    return CompareResult(
        max_abs_diff=max_diff,
        num_exceeding=exceeding,
        total=int(diff.size),
        status=status,
    )


def recall_at_k(
    result_ids: np.ndarray,
    oracle_ids: np.ndarray,
    result_dists: np.ndarray | None = None,
    oracle_dists: np.ndarray | None = None,
    tolerance: float = _c.DIST_TOLERANCE,
) -> float:
    """Mean fraction of oracle neighbors recovered per query.

    When distances are provided, a result id also counts as recovered if its
    distance ties the oracle's k-th distance within tolerance — the same
    tie-tolerant stance the reference takes by comparing distances instead of
    ids (compare_data.cpp:82-94 rationale).
    """
    result_ids = np.asarray(result_ids)
    oracle_ids = np.asarray(oracle_ids)
    if result_ids.shape != oracle_ids.shape:
        raise ValueError(
            f"shape mismatch: {result_ids.shape} vs {oracle_ids.shape}"
        )
    m, k = result_ids.shape
    hits = np.zeros(m, dtype=np.float64)
    for i in range(m):
        # Multiset intersection: the reference's tail-padding may legally
        # emit the same id twice (optimized.hpp:120-128 pads without a
        # duplicate check), and both copies should count as recovered.
        ra, rc = np.unique(result_ids[i], return_counts=True)
        oa, oc = np.unique(oracle_ids[i], return_counts=True)
        common, ia, ib = np.intersect1d(ra, oa, return_indices=True)
        inter = int(np.minimum(rc[ia], oc[ib]).sum())
        if result_dists is not None and oracle_dists is not None:
            # Credit near-ties: anything within tolerance of the oracle kth
            # distance is an acceptable substitute.
            kth = oracle_dists[i].max()
            tied = (~np.isin(result_ids[i], oracle_ids[i])) & (
                result_dists[i] <= kth + tolerance
            )
            inter = min(k, inter + int(tied.sum()))
        hits[i] = inter / k
    return float(hits.mean())
