"""Exact brute-force oracle — the readable correctness reference.

Plays the role of the reference's baseline engine (include/baseline.hpp:68-190)
in the differential test strategy (SURVEY.md §4): every optimized engine is
validated against this implementation under the 0.002 distance tolerance.

Semantics reproduced exactly (shared by all three reference engines):

* only the first ``sn = floor(sample_proportion * n)`` records are scanned
  (baseline.hpp:107, optimized.hpp:85);
* the squared-L2 distance skips the two attribute dims (io.h:38-48);
* predicates: type 0 none, type 1 ``C == v`` (float equality — C is
  discretized), type 2 ``l <= T <= r``, type 3 both (optimized.hpp:84-117);
* when fewer than k candidates pass, the result is padded with tail ids
  ``n-1, n-2, ...`` — taken from the *full* dataset regardless of ``sn`` or
  the predicate, with their true distances, duplicates allowed — until
  exactly k entries exist (optimized.hpp:120-128); everything is then sorted
  ascending by distance (optimized_impl.h:392-437).

Pure NumPy, query-at-a-time: O(m·sn·d). Use only for small configs and tests.
The PyTorch port's own copy of ``hvq_tpu.models.oracle``.
"""

from __future__ import annotations

import numpy as np

from hvq_tpu_torch import constants as _c
from hvq_tpu_torch.utils.formats import Dataset, QuerySet


def predicate_mask_np(
    ds: Dataset, qtype: int, v: float, l: float, r: float, sn: int
) -> np.ndarray:
    """Boolean mask over the first sn records for one query's predicate."""
    C, T = ds.C[:sn], ds.T[:sn]
    mask = np.ones(sn, dtype=bool)
    if qtype in (1, 3):
        mask &= C == np.float32(v)
    if qtype in (2, 3):
        mask &= (T >= np.float32(l)) & (T <= np.float32(r))
    return mask


def search_oracle(
    ds: Dataset,
    qs: QuerySet,
    k: int = _c.K_DEFAULT,
    sample_proportion: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact hybrid k-NN. Returns (ids (m,k) uint32, dists (m,k) float32)."""
    n = ds.n
    if n < k:
        raise ValueError(f"dataset has {n} < k={k} records")
    sn = int(sample_proportion * n)
    V64 = ds.V.astype(np.float64)  # high-precision oracle distances
    ids_out = np.empty((qs.m, k), dtype=np.uint32)
    dists_out = np.empty((qs.m, k), dtype=np.float32)

    for i in range(qs.m):
        mask = predicate_mask_np(
            ds, int(qs.qtype[i]), qs.v[i], qs.l[i], qs.r[i], sn
        )
        cand = np.nonzero(mask)[0]
        q = qs.V[i].astype(np.float64)
        if cand.size < k:
            # Pad with tail ids n-1, n-2, ... (duplicates allowed) until k
            # total entries exist (optimized.hpp:120-128).
            pad = np.arange(n - 1, n - 1 - (k - cand.size), -1, dtype=np.int64)
            cand = np.concatenate([cand, pad])
        # chunked so the (|cand|, 100) float64 temp never exceeds ~1 GB
        d = np.empty(cand.size, np.float64)
        for s in range(0, cand.size, 1 << 20):
            e = min(s + (1 << 20), cand.size)
            diff = V64[cand[s:e]] - q
            d[s:e] = np.einsum("jd,jd->j", diff, diff)
        order = np.argsort(d, kind="stable")[:k]
        ids_out[i] = cand[order].astype(np.uint32)
        dists_out[i] = d[order].astype(np.float32)

    return ids_out, dists_out


def search_oracle_batched(
    ds: Dataset,
    qs: QuerySet,
    k: int = _c.K_DEFAULT,
    sample_proportion: float = 1.0,
    qblock: int = 16,
    dchunk: int = 1 << 19,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized oracle — identical semantics to :func:`search_oracle`.

    ``qblock`` queries share one float64 BLAS matmul per database chunk
    (‖q‖² − 2·Q·Dᵀ + ‖d‖² expansion), which is 10-100× the scalar oracle's
    throughput on one host core — the bench's 64-query spot check becomes
    affordable where one query-at-a-time scan cost ~15-20 s (VERDICT r3
    #5b). Selection uses the expanded distances (float64 reassociation
    error ≲1e-12, irrelevant under the 0.002 tie credit); the RETURNED
    distances are recomputed per selected row with the scalar oracle's
    direct Σ(q−d)² float64 formula, so the two oracles agree bit-for-bit
    up to tie order.
    """
    n = ds.n
    if n < k:
        raise ValueError(f"dataset has {n} < k={k} records")
    sn = int(sample_proportion * n)
    ids_out = np.empty((qs.m, k), dtype=np.uint32)
    dists_out = np.empty((qs.m, k), dtype=np.float32)
    row_ids = np.arange(n, dtype=np.int64)

    for q0 in range(0, qs.m, qblock):
        q1 = min(q0 + qblock, qs.m)
        b = q1 - q0
        Q = qs.V[q0:q1].astype(np.float64)
        qn = np.einsum("bd,bd->b", Q, Q)
        qt = np.asarray(qs.qtype[q0:q1])
        vv = np.asarray(qs.v[q0:q1], np.float32)
        ll = np.asarray(qs.l[q0:q1], np.float32)
        rr = np.asarray(qs.r[q0:q1], np.float32)
        has_c = (qt == 1) | (qt == 3)
        has_t = (qt == 2) | (qt == 3)
        best_d = np.full((b, k), np.inf)
        best_i = np.zeros((b, k), np.int64)
        for s in range(0, sn, dchunk):
            e = min(s + dchunk, sn)
            D = ds.V[s:e].astype(np.float64)
            d2 = (
                qn[:, None]
                - 2.0 * (Q @ D.T)
                + np.einsum("nd,nd->n", D, D)[None, :]
            )
            np.maximum(d2, 0.0, out=d2)
            if has_c.any():
                Cc = np.asarray(ds.C[s:e], np.float32)
                d2[has_c] = np.where(
                    Cc[None, :] == vv[has_c, None], d2[has_c], np.inf
                )
            if has_t.any():
                Tc = np.asarray(ds.T[s:e], np.float32)
                d2[has_t] = np.where(
                    (Tc[None, :] >= ll[has_t, None])
                    & (Tc[None, :] <= rr[has_t, None]),
                    d2[has_t],
                    np.inf,
                )
            cat_d = np.concatenate([best_d, d2], axis=1)
            cat_i = np.concatenate(
                [best_i, np.broadcast_to(row_ids[s:e], (b, e - s))], axis=1
            )
            sel = np.argpartition(cat_d, k - 1, axis=1)[:, :k]
            best_d = np.take_along_axis(cat_d, sel, axis=1)
            best_i = np.take_along_axis(cat_i, sel, axis=1)
        for j in range(b):
            finite = np.isfinite(best_d[j])
            cand = best_i[j][finite]
            if cand.size < k:
                pad = np.arange(
                    n - 1, n - 1 - (k - cand.size), -1, dtype=np.int64
                )
                cand = np.concatenate([cand, pad])
            diff = ds.V[cand].astype(np.float64) - Q[j]
            d = np.einsum("jd,jd->j", diff, diff)
            order = np.argsort(d, kind="stable")[:k]
            ids_out[q0 + j] = cand[order].astype(np.uint32)
            dists_out[q0 + j] = d[order].astype(np.float32)
    return ids_out, dists_out


class OracleEngine:
    """Engine-protocol wrapper around :func:`search_oracle`."""

    name = "oracle"

    def __init__(self, ds: Dataset, **_unused):
        self.ds = ds

    def search(
        self,
        qs: QuerySet,
        k: int = _c.K_DEFAULT,
        sample_proportion: float = 1.0,
    ) -> tuple[np.ndarray, np.ndarray]:
        return search_oracle(self.ds, qs, k=k, sample_proportion=sample_proportion)
