"""IVF index, balanced bucketed coarse quantization: the counterpart of
``hvq_tpu.index.ivf``.

The database is clustered (``ops.kmeans`` on the device), reordered
cluster-major and cut into fixed-capacity buckets, so every probe is one
contiguous ``cap``-row block of the view. Buckets are cluster-aligned:
each holds rows of exactly one k-means cluster (clusters are padded up to
a multiple of ``cap``), and a bucket's centroid is the mean of its real
rows, so the probe ranks exactly the blocks it will scan.

Selectivity statistics (category histogram, timestamp sample) come from
the attributes only; building never sees a query vector (reference
README.md:68).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hvq_tpu_torch import constants as _c
from hvq_tpu_torch.models.device_db import resolve_device, upload
from hvq_tpu_torch.ops.distance import squared_norms
from hvq_tpu_torch.ops.kmeans import fit_kmeans
from hvq_tpu_torch.utils.formats import Dataset

# Row chunks of the on-device layout gather (bounds its temporary).
_GATHER_CHUNKS = 8


@dataclasses.dataclass
class IVFIndex:
    # device tensors (rows in cluster-major bucket order, padded to n_pad)
    Vp: torch.Tensor          # (n_pad, 128) fp32
    C: torch.Tensor           # (n_pad,) fp32, padding rows +inf
    T: torch.Tensor           # (n_pad,) fp32, padding rows +inf
    oid: torch.Tensor         # (n_pad,) int32; padding rows hold n
    d_norms: torch.Tensor     # (n_pad,) ‖d‖² (the exact-scan fallback's)
    centroids: torch.Tensor   # (nb, 128) bucket means
    c_norms: torch.Tensor     # (nb,)
    n: int
    cap: int
    scan_tile: int            # tile width of the exact-scan fallback
    # host selectivity statistics (built from attributes only)
    cat_vals: np.ndarray      # sorted unique C values
    cat_freq: np.ndarray      # fraction of rows per value
    t_sample: np.ndarray      # sorted T subsample (empirical CDF)

    @property
    def num_buckets(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_pad(self) -> int:
        return self.Vp.shape[0]

    @property
    def device(self) -> torch.device:
        return self.Vp.device

    # --- selectivity estimation (host) -------------------------------------
    def selectivity(self, qtype: np.ndarray, v: np.ndarray, l: np.ndarray,
                    r: np.ndarray) -> np.ndarray:
        """Estimated fraction of rows passing each query's predicate."""
        m = qtype.shape[0]
        sel = np.ones(m, np.float64)
        has_c = np.isin(qtype, (1, 3))
        if has_c.any():
            pos = np.searchsorted(self.cat_vals, v[has_c])
            pos = np.clip(pos, 0, max(self.cat_vals.size - 1, 0))
            hit = (
                self.cat_vals[pos] == v[has_c]
                if self.cat_vals.size
                else np.zeros(has_c.sum(), bool)
            )
            sel[has_c] = np.where(hit, self.cat_freq[pos], 0.0)
        has_t = np.isin(qtype, (2, 3))
        if has_t.any():
            lo = np.searchsorted(self.t_sample, l[has_t], side="left")
            hi = np.searchsorted(self.t_sample, r[has_t], side="right")
            sel[has_t] *= (hi - lo) / max(self.t_sample.size, 1)
        return sel

    @classmethod
    def build(
        cls,
        ds: Dataset,
        cap: int = 1024,
        n_clusters: int | None = None,
        iters: int = 8,
        seed: int = 0,
        kmeans_tile: int = 65536,
        device: torch.device | str = "cuda",
    ) -> "IVFIndex":
        """Cluster on the device, then lay out cluster-aligned buckets.

        Cluster c gets ceil(count_c / cap) buckets; the padding overhead is
        ≤ ``n_clusters·(cap−1)`` rows. The default ``n_clusters =
        ceil(n/cap)`` trades that memory for the cleanest neighbourhoods.
        The raw rows are uploaded once; the k-means padding, the layout
        gather, ‖d‖² and the bucket means are made on the device.
        """
        device = resolve_device(device)
        n, dim = ds.V.shape
        k = n_clusters or max(1, -(-n // cap))
        V_dev = upload(np.asarray(ds.V, np.float32), device)
        # pad rows so the k-means scan tiles evenly
        km_tile = min(kmeans_tile, 1 << (max(n, 1) - 1).bit_length())
        n_km = -(-n // km_tile) * km_tile
        Vp_km = torch.zeros((n_km, _c.PADDED_DIM), dtype=torch.float32, device=device)
        Vp_km[:n, :dim] = V_dev
        _, assign = fit_kmeans(Vp_km, n, k, iters=iters, db_tile=km_tile, seed=seed)
        del Vp_km

        # cluster-aligned layout (host): cluster c gets ceil(count_c/cap) buckets
        counts = np.bincount(assign, minlength=k)
        nbuckets_per = -(-counts // cap)               # 0 for empty clusters
        nb = int(nbuckets_per.sum())
        # pad total rows so the exact-scan fallback tiles evenly too
        scan_tile = max(cap, 8192) if n >= 8192 else cap
        n_pad = -(-(nb * cap) // scan_tile) * scan_tile
        cluster_row_start = np.concatenate([[0], np.cumsum(nbuckets_per * cap)])[:-1]
        order = np.argsort(assign, kind="stable").astype(np.int64)
        src_cluster_start = np.concatenate([[0], np.cumsum(counts)])[:-1]
        within = np.arange(n) - src_cluster_start[assign[order]]
        dest = cluster_row_start[assign[order]] + within

        C_r = np.full(n_pad, np.inf, np.float32)
        T_r = np.full(n_pad, np.inf, np.float32)
        oid = np.full(n_pad, n, np.int32)
        C_r[dest] = ds.C[order]
        T_r[dest] = ds.T[order]
        oid[dest] = order.astype(np.int32)

        V_r = torch.zeros((n_pad, _c.PADDED_DIM), dtype=torch.float32, device=device)
        order_t, dest_t = upload(order, device), upload(dest, device)
        bounds = np.linspace(0, n, _GATHER_CHUNKS + 1).astype(np.int64)
        for s, e in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
            V_r[dest_t[s:e], :dim] = V_dev.index_select(0, order_t[s:e])
        del V_dev, order_t, dest_t

        # bucket means over the real rows of each bucket
        valid = oid < n
        nbc = nb * cap
        w = upload(valid[:nbc].astype(np.float32), device)
        sums = (V_r[:nbc] * w[:, None]).view(nb, cap, -1).sum(dim=1)
        bcounts = upload(valid[:nbc].reshape(nb, cap).sum(axis=1).astype(np.float32), device)
        cents = sums / bcounts.clamp(min=1.0)[:, None]

        # attribute-only selectivity statistics (never touches vectors)
        cat_vals, cat_counts = np.unique(ds.C, return_counts=True)
        t_sample = np.sort(
            ds.T if n <= 65536
            else np.random.default_rng(0).choice(ds.T, 65536, replace=False)
        )
        return cls(
            Vp=V_r, C=upload(C_r, device), T=upload(T_r, device),
            oid=upload(oid, device), d_norms=squared_norms(V_r),
            centroids=cents, c_norms=squared_norms(cents), n=n, cap=cap,
            scan_tile=scan_tile, cat_vals=cat_vals.astype(np.float32),
            cat_freq=(cat_counts / n).astype(np.float64),
            t_sample=t_sample.astype(np.float32),
        )

    @classmethod
    def from_host(
        cls,
        Vp: np.ndarray,
        C: np.ndarray,
        T: np.ndarray,
        oid: np.ndarray,
        d_norms: np.ndarray,
        centroids: np.ndarray,
        c_norms: np.ndarray,
        n: int,
        cap: int,
        scan_tile: int,
        cat_vals: np.ndarray,
        cat_freq: np.ndarray,
        t_sample: np.ndarray,
        device: torch.device | str = "cuda",
    ) -> "IVFIndex":
        """An index from host arrays another build laid out, e.g. each field
        of the JAX package's ``IVFIndex`` through ``np.asarray``, or a
        checkpoint's (``index.serialize``): both packages then search
        identical stored state."""
        device = resolve_device(device)
        Vp = np.asarray(Vp, np.float32)
        n, cap, scan_tile = int(n), int(cap), int(scan_tile)
        if Vp.ndim != 2 or Vp.shape[1] != _c.PADDED_DIM:
            raise ValueError(f"Vp must be (n_pad, {_c.PADDED_DIM}), got {Vp.shape}")
        n_pad = Vp.shape[0]
        if n_pad % scan_tile or n_pad % cap or not 0 < n <= n_pad:
            raise ValueError(f"n_pad {n_pad} must cover n {n} in {cap}- and "
                             f"{scan_tile}-row tiles")
        cols = [np.asarray(x, np.float32) for x in (C, T, d_norms)]
        oid = np.asarray(oid)
        if any(x.shape != (n_pad,) for x in (*cols, oid)):
            raise ValueError(f"C, T, d_norms, oid must be ({n_pad},)")
        if oid.dtype != np.int32:
            raise ValueError(f"oid must be int32, got {oid.dtype}")
        cents = np.asarray(centroids, np.float32)
        c_norms = np.asarray(c_norms, np.float32)
        if cents.ndim != 2 or cents.shape[1] != _c.PADDED_DIM or c_norms.shape != cents.shape[:1]:
            raise ValueError("centroids must be (nb, 128) with c_norms (nb,)")
        C_t, T_t, dn_t = (upload(x, device) for x in cols)
        return cls(
            Vp=upload(Vp, device), C=C_t, T=T_t, oid=upload(oid, device),
            d_norms=dn_t, centroids=upload(cents, device),
            c_norms=upload(c_norms, device), n=n, cap=cap, scan_tile=scan_tile,
            cat_vals=np.asarray(cat_vals, np.float32),
            cat_freq=np.asarray(cat_freq, np.float64),
            t_sample=np.asarray(t_sample, np.float32),
        )
