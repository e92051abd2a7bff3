"""IVF approximate engine, bucket-major probes over a clustered layout:
the counterpart of ``hvq_tpu.models.ivf``.

  1. rank the bucket centroids for the whole query set (one fp32 product,
     TF32 off) and keep each query's top ``nprobe`` buckets;
  2. host: union the probed buckets of each query batch; every bucket is a
     contiguous ``cap``-row block of the view;
  3. device: score the union's rows, either all at once with one top-k′
     (the flat path, while the (B, union·cap) score block fits
     ``flat_budget_bytes``) or through the streaming per-chunk top-k′
     merge (``common.scan_database(tile_index=)``). No bin reduce:
     clustered queries keep their whole top-k inside a couple of probed
     buckets, where a per-bin cap would lose neighbours wholesale;
  4. exact fp32 refinement of the survivors, mapped to original ids, and
     the reference tail padding (``common.finalize(oid=)``).

Scanning the union instead of per-query lists can only add candidates.

**Filtered probes**: a predicate of selectivity s thins every bucket, so
the probe count scales as ``nprobe / s``, estimated from the index's
attribute statistics; counts are bucketed to powers of two (the JAX
engine's jit buckets, kept so the flat/stream choice is the same), and
near-full-scan counts route to an exact masked scan of the IVF view.

The JAX engine reaches no Pallas kernel (its products are XLA
``dot_general``), so neither does this one: its products are
``torch.matmul`` through ``ops.distance``. Recall is gated ≥ 0.99 against
the oracle on clustered data.
"""

from __future__ import annotations

import numpy as np
import torch

from hvq_tpu_torch import constants as _c
from hvq_tpu_torch.index.ivf import IVFIndex
from hvq_tpu_torch.models import common
from hvq_tpu_torch.models.batched import pack_query_block, unpack_query_block
from hvq_tpu_torch.models.device_db import resolve_device, upload, upload_async
from hvq_tpu_torch.ops.distance import mm_nt, require_ieee_fp32, tile_scores
from hvq_tpu_torch.ops.masks import block_mask
from hvq_tpu_torch.ops.topk import smallest_k
from hvq_tpu_torch.utils.formats import Dataset, QuerySet
from hvq_tpu_torch.utils.timing import maybe_phase, request_span


class IVFEngine:
    """Approximate bucketed-IVF engine with selectivity-aware routing.

    The constructor takes the JAX engine's keywords, plus ``device``; a
    given ``index`` must live on that device (``IVFIndex.from_host``
    carries one across). After ``search()``, ``last_route`` counts the
    flat, streaming and exact-scan batches.
    """

    name = "ivf"

    def __init__(
        self,
        ds: Dataset,
        device: torch.device | str = "cuda",
        cap: int = 1024,
        nprobe: int = 16,
        exact_frac: float = 0.25,
        query_batch: int = 256,
        kprime: int = 128,
        kmeans_iters: int = 8,
        n_clusters: int | None = None,
        seed: int = 0,
        index: IVFIndex | None = None,
        flat_budget_bytes: int = 512 * 1024 * 1024,
    ):
        self.device = resolve_device(device)
        require_ieee_fp32(self.device)
        if index is None:
            index = IVFIndex.build(ds, cap=cap, n_clusters=n_clusters,
                                   iters=kmeans_iters, seed=seed, device=self.device)
        elif index.device != self.device:
            raise ValueError(f"index lives on {index.device}, engine on {self.device}")
        self.index = index
        self.nprobe = min(nprobe, index.num_buckets)
        self.exact_frac = exact_frac
        self.query_batch = int(query_batch)
        self.kprime = int(kprime)
        self.flat_budget_bytes = int(flat_budget_bytes)
        self.tail_V = upload(common.tail_block_np(ds.V, t=self.kprime), self.device)
        self.last_route: dict = {}

    # --- device stages ------------------------------------------------------
    def _rank_buckets(self, qV: torch.Tensor, p: int) -> torch.Tensor:
        """(m, p) probed bucket ids of (m, 128) queries, nearest first."""
        idx = self.index
        c_scores = idx.c_norms[None, :] - 2.0 * mm_nt(qV, idx.centroids)
        return smallest_k(c_scores, p)[1].to(torch.int32)

    def _union_scan(self, qb, tile_index: np.ndarray, sn: int, k: int):
        """Streaming union scan: the probed buckets' per-chunk top-k′ merge."""
        idx = self.index
        scores, pos = common.scan_database(
            idx.Vp, idx.C, idx.T, idx.d_norms, qb, sn, kprime=self.kprime,
            db_tile=idx.cap, oid=idx.oid, tile_index=tile_index)
        return common.finalize(scores, pos, idx.Vp, qb, idx.n, k, self.tail_V,
                               oid=idx.oid)

    def _union_scan_flat(self, qb, tile_index: np.ndarray, sn: int, k: int):
        """Flat union path: every score of the (padded) union's rows, then
        ONE top-k′ over the (B, W) block. Padding slots (-1) score +inf."""
        idx = self.index
        cap = idx.cap
        ti = torch.from_numpy(tile_index.astype(np.int64)).to(self.device)
        lane = torch.arange(cap, device=self.device)
        rows = (ti.clamp(min=0)[:, None] * cap + lane).reshape(-1)   # (W,)
        live = (ti >= 0)[:, None].expand(-1, cap).reshape(-1)
        s = tile_scores(qb.qV, idx.Vp[rows], idx.d_norms[rows], "highest")
        ok = block_mask(idx.C[rows], idx.T[rows], idx.oid[rows], sn,
                        qb.active_c, qb.v, qb.active_t, qb.l, qb.r) & live
        top, flat = smallest_k(s.masked_fill_(~ok, float("inf")),
                               min(self.kprime, rows.numel()))
        del s, ok
        return common.finalize(top, rows[flat].to(torch.int32), idx.Vp, qb, idx.n,
                               k, self.tail_V, oid=idx.oid)

    def _scan_batch(self, qb, sn: int, k: int):
        """Exact fallback: the full masked streaming scan of the IVF view."""
        idx = self.index
        scores, pos = common.scan_database(
            idx.Vp, idx.C, idx.T, idx.d_norms, qb, sn,
            kprime=max(self.kprime, k), db_tile=idx.scan_tile, oid=idx.oid)
        return common.finalize(scores, pos, idx.Vp, qb, idx.n, k, self.tail_V,
                               oid=idx.oid)

    # --- host side ------------------------------------------------------------
    @request_span
    def search(
        self,
        qs: QuerySet,
        k: int = _c.K_DEFAULT,
        sample_proportion: float = 1.0,
        return_dists: bool = True,
        phases=None,
    ) -> tuple[np.ndarray, np.ndarray | None]:
        """The engines' contract (``return_dists=False`` skips the
        distances); ``phases`` receives the route, probe, enqueue and fetch
        split."""
        idx = self.index
        sn = int(sample_proportion * idx.n)
        B = self.query_batch
        nb = idx.num_buckets

        # Route: probes scaled by 1/selectivity, bucketed to powers of two;
        # near-full-scan probe counts go to the exact masked scan instead.
        with maybe_phase(phases, "search/route"):
            sel = idx.selectivity(qs.qtype, qs.v, qs.l, qs.r)
            need = np.ceil(self.nprobe / np.maximum(sel, 1e-9))
            exact = need > max(self.exact_frac * nb, self.nprobe)
            np_eff = np.minimum(
                2 ** np.ceil(np.log2(np.maximum(need, 1))).astype(np.int64), nb)
            np_eff[exact] = 0  # exact-scan marker

        # probe rankings for every non-exact query in one product
        probe_idx = np.nonzero(np_eff > 0)[0]
        buckets_all = None
        if probe_idx.size:
            with maybe_phase(phases, "search/probe"):
                p_max = int(np_eff[probe_idx].max())
                qV = np.zeros((probe_idx.size, _c.PADDED_DIM), np.float32)
                qV[:, : qs.V.shape[1]] = qs.V[probe_idx]
                buckets_all = self._rank_buckets(
                    upload(qV, self.device), p_max).cpu().numpy()
                probe_row = np.full(qs.m, -1, np.int64)
                probe_row[probe_idx] = np.arange(probe_idx.size)

        routes = dict(flat=0, stream=0, exact=0)
        pending = []
        with maybe_phase(phases, "search/enqueue"):
            for p in np.unique(np_eff):
                q_idx = np.nonzero(np_eff == p)[0]
                for s in range(0, q_idx.size, B):
                    batch_idx = q_idx[s : s + B]
                    qb = self._query_batch(batch_idx, qs)
                    if p == 0:
                        routes["exact"] += 1
                        ids, d = self._scan_batch(qb, sn, k)
                    else:
                        probes = buckets_all[probe_row[batch_idx]][:, : int(p)]
                        ids, d = self._run_union(qb, probes, sn, k, routes)
                    pending.append((batch_idx, torch.cat([ids, d.view(torch.int32)], 1)))
        ids_out = np.empty((qs.m, k), dtype=np.uint32)
        dists_out = np.empty((qs.m, k), dtype=np.float32) if return_dists else None
        with maybe_phase(phases, "search/fetch"):
            for batch_idx, res in pending:
                host = res.cpu().numpy()[: batch_idx.size]
                ids_out[batch_idx] = host[:, :k].astype(np.uint32)
                if return_dists:
                    dists_out[batch_idx] = host[:, k:].view(np.float32)
        self.last_route = routes
        return ids_out, dists_out

    def _query_batch(self, batch_idx: np.ndarray, qs: QuerySet) -> common.QueryBatch:
        """The batch's queries padded to ``query_batch`` rows (type 0, zero
        vectors, v/l/r = -1), uploaded as one packed block."""
        B, bsz = self.query_batch, batch_idx.size
        Q = pack_query_block(np.zeros((B, _c.VEC_DIM), np.float32),
                             np.zeros(B), -1.0, -1.0, -1.0)
        Q[:bsz] = pack_query_block(qs.V[batch_idx].astype(np.float32),
                                   qs.qtype[batch_idx], qs.v[batch_idx],
                                   qs.l[batch_idx], qs.r[batch_idx])
        return unpack_query_block(upload_async(Q, self.device))

    def _run_union(self, qb, probes: np.ndarray, sn: int, k: int, routes: dict):
        idx = self.index
        union = np.unique(probes)
        nt_sel = max(1, int(union.size))
        size = 1 << (nt_sel - 1).bit_length()          # the JAX jit buckets
        tile_index = np.full(size, -1, np.int32)
        tile_index[: union.size] = union
        # flat path while the (B, W) score block fits the byte budget;
        # beyond it the streaming merge caps device memory
        if self.query_batch * size * idx.cap * 4 <= self.flat_budget_bytes:
            routes["flat"] += 1
            return self._union_scan_flat(qb, tile_index, sn, k)
        routes["stream"] += 1
        return self._union_scan(qb, tile_index, sn, k)
