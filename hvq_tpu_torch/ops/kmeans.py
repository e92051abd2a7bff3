"""Tiled k-means on the device: the counterpart of ``hvq_tpu.ops.kmeans``,
the coarse quantizer of the IVF index.

Assignment is the search scan's pattern: per database tile, the (Dt, k)
centroid scores ‖c‖² − 2·v·c as one fp32 product (TF32 off, so the IEEE
product the JAX package computes on a CPU), then an argmin per row; sums
and counts accumulate by ``index_add_``. The data stays on the device
between iterations. Building the index never sees query vectors
(reference README.md:68).
"""

from __future__ import annotations

import numpy as np
import torch

from hvq_tpu_torch.ops.distance import mm_nt, require_ieee_fp32


def _scores(V_tile: torch.Tensor, centroids: torch.Tensor, c_norms: torch.Tensor):
    """(Dt, k) fp32 ‖c‖² − 2·v·c of one tile against every centroid."""
    return c_norms[None, :] - 2.0 * mm_nt(V_tile, centroids)


def _lloyd_iteration(Vt: torch.Tensor, valid_t: torch.Tensor, centroids: torch.Tensor):
    """One Lloyd step. Vt (nt, Dt, d); valid_t (nt, Dt) bool row-valid mask.

    Returns (new_sums (k, d), counts (k,), cost scalar tensor)."""
    k, d = centroids.shape
    c_norms = (centroids * centroids).sum(dim=1)
    sums = torch.zeros((k, d), dtype=torch.float32, device=Vt.device)
    counts = torch.zeros(k, dtype=torch.float32, device=Vt.device)
    cost = torch.zeros((), dtype=torch.float32, device=Vt.device)
    for V_tile, valid in zip(Vt, valid_t):
        scores = _scores(V_tile, centroids, c_norms)
        assign = scores.argmin(dim=1)
        best = scores.gather(1, assign[:, None])[:, 0]
        w = valid.to(torch.float32)
        sums.index_add_(0, assign, V_tile * w[:, None])
        counts.index_add_(0, assign, w)
        cost += torch.where(valid, best, 0.0).sum()
        del scores
    return sums, counts, cost


def assign_clusters(Vt: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Final hard assignment: (nt, Dt, d) → flat (nt·Dt,) int32 cluster ids."""
    c_norms = (centroids * centroids).sum(dim=1)
    return torch.cat([_scores(V_tile, centroids, c_norms).argmin(dim=1)
                      for V_tile in Vt]).to(torch.int32)


def fit_kmeans(
    Vp: torch.Tensor,      # (n_pad, d) device vectors (zero rows padded)
    n: int,                # true row count
    k: int,
    iters: int = 8,
    db_tile: int = 65536,
    seed: int = 0,
) -> tuple[torch.Tensor, np.ndarray]:
    """Fit k centroids; returns (centroids (k, d) on Vp's device, assignment
    (n,) host int32).

    Initialization: k distinct rows sampled uniformly by the host RNG
    (``np.random.default_rng(seed).choice``, the rows the JAX package
    starts from). Empty clusters keep their previous centroid.
    """
    require_ieee_fp32(Vp.device)
    n_pad, d = Vp.shape
    db_tile = min(db_tile, n_pad)
    if n_pad % db_tile:
        raise ValueError(f"n_pad {n_pad} not divisible by db_tile {db_tile}")
    nt = n_pad // db_tile
    Vt = Vp.reshape(nt, db_tile, d).to(torch.float32)
    valid_t = (torch.arange(n_pad, device=Vp.device) < n).reshape(nt, db_tile)

    rng = np.random.default_rng(seed)
    init_rows = rng.choice(n, size=min(k, n), replace=False)
    centroids = Vp[torch.from_numpy(init_rows).to(Vp.device)].to(torch.float32)
    if k > n:  # degenerate tiny datasets
        centroids = torch.cat(
            [centroids, torch.zeros((k - n, d), dtype=torch.float32, device=Vp.device)])

    for _ in range(iters):
        sums, counts, _cost = _lloyd_iteration(Vt, valid_t, centroids)
        safe = counts[:, None].clamp(min=1.0)
        centroids = torch.where(counts[:, None] > 0, sums / safe, centroids)

    assign = assign_clusters(Vt, centroids).cpu().numpy()[:n]
    return centroids, assign
