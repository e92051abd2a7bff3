"""Sharded partitioned engine: the counterpart of
``hvq_tpu.models.partitioned_sharded``.

Both sorted views are built with ``row_multiple = n_d · db_tile`` and split
over the mesh's "d" axis (q = 1), one contiguous slab of each view a shard
(``parallel.mesh.shard_rows``: views of one copy where shards share a
device). Each of the partitioned engine's dispatch kinds runs where its
rows live:

* **full** (dense): the shared per-slab stage (``models.batched.slab_scan``)
  on every slab's scan plane, K1 on a card, with the slab's ``oid`` as the
  ids of the sample limit; the candidates are refined on the owning shard
  and turned into ORIGINAL ids there, so the shards' (B, k′) tiles merge
  (``parallel.collectives``) with unique ids and no cross-shard row
  gather; each certificate term takes its minimum over the shards.
* **routed**: a routed group's window lies inside one shard's slab: spans
  that straddle a slab boundary go dense (``_routable_extra``), and the
  groups are packed per slab and dispatched on the shard that owns them,
  the shards' queues drained round-robin. Each query is wholly owned by
  one shard: no merge.
* **windowed** wide type-2 batches are off on the mesh
  (``_enable_window``), as in the JAX engine: wide ranges take the dense
  path, which is exact for every type.

Suspects go through the partitioned engine's ladder: rung 1 this dense
scan at 2R without level 2, rung 2 the per-shard streaming scan and the
merge. The views are built whole on the mesh's first device before they
are split, as the JAX engine builds them on its default device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from hvq_tpu_torch.index.partition import PartitionedIndex, SortedView
from hvq_tpu_torch.models import common
from hvq_tpu_torch.models.batched import (
    Slab,
    certificate,
    check_unported,
    pack_result,
    slab_scan,
    unpack_query_block,
)
from hvq_tpu_torch.models.device_db import upload_async
from hvq_tpu_torch.models.partitioned import SCAN_IMPLS, PartitionedEngine
from hvq_tpu_torch.ops.scan import choose_bin_top
from hvq_tpu_torch.ops.topk import BIN
from hvq_tpu_torch.parallel.collectives import allgather_topk_merge, min_terms
from hvq_tpu_torch.parallel.mesh import engine_mesh, shard_rows
from hvq_tpu_torch.utils.formats import Dataset
from hvq_tpu_torch.utils.timing import maybe_phase


class MeshView(NamedTuple):
    """A sorted view placed on the mesh: the whole view (host keys, sizes)
    and one slab of it a shard, each a SortedView of ``local_n`` rows."""

    view: SortedView
    shards: list


def _slab(v: SortedView) -> Slab:
    return Slab(v.Vp, v.scan_V, v.C, v.T, v.d_norms, v.oid)


class ShardedPartitionedEngine(PartitionedEngine):
    """Partitioned routing and certified dense scans over a "d" device mesh.

    Takes the partitioned engine's keywords, plus ``mesh`` and ``device``
    (as ``models.sharded.ShardedEngine``: None builds the mesh from
    ``device``, every visible card by default). The mesh must have q = 1.
    The route buckets are capped at a shard's rows, and a database too
    small for a sound per-shard bin depth streams its dense batches
    instead of routing everything (``_route_all_fallback`` off).
    """

    name = "partitioned_sharded"

    def __init__(
        self,
        ds: Dataset,
        mesh=None,
        db_tile: int | None = None,
        kprime: int | None = None,
        dtype=torch.float32,
        bin_top: int | None = None,
        device: torch.device | str | None = None,
        query_batch: int = 1024,
        scan_store: str = "fp32",
        precision: str = "high",
        topk_strategy: str = "topk",
        scan_impl: str = "auto",
        route_buckets: tuple[int, ...] = (4096, 32768),
        route_group: int = 16,
        routed_batch: int | None = None,
        dispatch_group: int = 8,
        certified: bool = True,
        l2_min_w: int = 16384,
        scan_layout: str = "axis1",
        repair_bins: int = 0,
        repair_gate: bool = False,
        time_view_min_queries: int = 4096,
        time_view_max_bytes: int | None = None,
    ):
        check_unported(dtype, topk_strategy, repair_bins, repair_gate)
        if scan_impl not in SCAN_IMPLS:
            raise ValueError(f"unknown scan_impl {scan_impl!r}; one of {tuple(SCAN_IMPLS)}")
        self.mesh = engine_mesh(mesh, device)
        if self.mesh.shape["q"] != 1:
            raise ValueError(
                "partitioned_sharded shards the database only; put all "
                "devices on the 'd' axis (query parallelism is query_batch)")
        self.n_d = self.mesh.shape["d"]
        home = self.mesh.devices[0, 0]
        if db_tile is None:
            db_tile = 16384 if SCAN_IMPLS[scan_impl] == "v3" else 8192
        index = PartitionedIndex.build(ds, db_tile=db_tile, device=home,
                                       scan_store=scan_store,
                                       row_multiple=self.n_d * db_tile)
        super().__init__(
            ds, device=home, db_tile=db_tile, query_batch=query_batch, kprime=kprime,
            dtype=dtype, scan_store=scan_store, precision=precision,
            topk_strategy=topk_strategy, scan_impl=scan_impl, index=index,
            route_buckets=route_buckets, route_group=route_group,
            routed_batch=routed_batch, dispatch_group=dispatch_group,
            certified=certified, bin_top=bin_top, l2_min_w=l2_min_w,
            scan_layout=scan_layout, repair_bins=repair_bins, repair_gate=repair_gate,
            time_view_min_queries=time_view_min_queries,
            time_view_max_bytes=time_view_max_bytes,
        )
        self._local_n = index.cat_view.n_pad // self.n_d
        # the bin depth is a property of each shard's LOCAL scan; a tile of
        # no whole 128-row bins has none
        if bin_top is None:
            self.bin_top = (choose_bin_top(self._local_n, self.kprime,
                                           certified=self.certified)
                            if db_tile % BIN == 0 else None)
        # with no sound bin depth the dense path streams per shard instead
        # of routing every query (a cap could exceed a slab)
        self._route_all_fallback = False
        self._enable_window = False
        # a routed window must fit inside one slab
        self.route_buckets = tuple(c for c in self.route_buckets if c <= self._local_n)
        self._placed: dict[int, MeshView] = {}
        self._get_view(0)

    # --- mesh placement ----------------------------------------------------
    def _get_view(self, vid: int) -> MeshView:
        """View ``vid`` (0 = cat, 1 = time, built on first use) placed on
        the mesh: one slab a shard, on its device."""
        if vid not in self._placed:
            view = self.index.cat_view if vid == 0 else self.index.time_view
            cols = {f: shard_rows(self.mesh, getattr(view, f))[0]
                    for f in ("Vp", "C", "T", "d_norms", "oid")}
            planes = (shard_rows(self.mesh, view.V_scan)[0] if view.V_scan is not None
                      else [None] * self.n_d)
            shards = [dataclasses.replace(view, **{f: c[j] for f, c in cols.items()},
                                          V_scan=planes[j])
                      for j in range(self.n_d)]
            self._placed[vid] = MeshView(view, shards)
        return self._placed[vid]

    def _routable_extra(self, start, end) -> np.ndarray:
        # a routed window must live inside ONE slab; spans straddling a
        # boundary take the dense path
        last = np.maximum(end - 1, start)
        return (start // self._local_n) == (last // self._local_n)

    # --- device paths -------------------------------------------------------
    def _sharded_scan(self, mv: MeshView, Q: torch.Tensor, sn: int, n: int,
                      k: int, bin_top: int | None, level2: bool, impl: str,
                      phases=None):
        """The per-shard stage on every slab, candidates turned into
        original ids on their shard, the merge and the certificate → home
        device (ids int32 (B, k), suspect bool (B,), dists fp32 (B, k))."""
        home = self.device
        qbs = {}
        exact, oids, terms = [], [], []
        for v in mv.shards:
            if v.device not in qbs:
                qbs[v.device] = unpack_query_block(Q.to(v.device, non_blocking=True))
            e, pos, t = slab_scan(self, _slab(v), qbs[v.device], sn, self.kprime, impl,
                                  bin_top, v.db_tile, level2, phases)
            exact.append(e)
            oids.append(v.oid[pos.long()])      # slab positions → original ids
            terms.append(t)
        with maybe_phase(phases, "mesh/merge"):
            m_d, m_i = allgather_topk_merge(exact, oids, self.kprime, home)
            t = min_terms(terms, home)
        del exact, oids, terms
        qb = qbs[home]
        with maybe_phase(phases, "batch/finalize"):
            f_ids, f_d = common.finalize_with_tail(m_d, m_i, self.tail_V, qb, n, k)
        if self.certified and impl != "stream":
            with maybe_phase(phases, "batch/certificate"):
                suspect = certificate(f_d, qb.qV, t, self._rel_mm, self._dn_max, k)
        else:
            suspect = torch.zeros(f_d.shape[0], dtype=torch.bool, device=home)
        return f_ids, suspect, f_d

    def _search_full(self, mv: MeshView, Q: torch.Tensor, sn: int, n: int,
                     k: int, bin_top: int | None = None, level2: bool = True,
                     row0: int | None = None, ntw: int | None = None,
                     phases=None):
        """The dense path: the certified packed scan on every slab (the
        plain streaming scan where there is no bin depth)."""
        if row0 is not None:
            raise ValueError("the window path is off on a mesh")
        bin_top = bin_top or self.bin_top
        impl = "stream" if bin_top is None else self.scan_impl
        return self._sharded_scan(mv, Q, sn, n, k, bin_top, level2, impl, phases)

    def _search_stream(self, mv: MeshView, Q: torch.Tensor, sn: int, n: int, k: int):
        """The ladder's last rung: the per-shard streaming scan and the merge."""
        return self._sharded_scan(mv, Q, sn, n, k, None, False, "stream")

    def _enqueue_routed(self, mv: MeshView, q_idx, start, end, Qpack, sn, n, k,
                        pending) -> tuple[dict, int]:
        """Shard-aware routed packing: groups are packed per slab and
        dispatched on the shard that owns their window, in its own
        coordinates, the shards' queues drained round-robin so shards on
        different devices work at once."""
        ln = self._local_n
        slab_of = start[q_idx] // ln
        by_cap: dict[int, list] = {}
        for sh in np.unique(slab_of):
            for cap, glist in self._pack_groups(start, end, q_idx[slab_of == sh]).items():
                by_cap.setdefault(cap, [[] for _ in range(self.n_d)])[int(sh)].extend(glist)
        counts = {cap: sum(map(len, queues)) for cap, queues in by_cap.items()}
        dispatches = 0
        for cap in sorted(by_cap):
            queues = by_cap[cap]
            while any(queues):
                for sh, queue in enumerate(queues):
                    if not queue:
                        continue
                    chunk, queues[sh] = queue[: self.routed_groups], queue[self.routed_groups :]
                    g_start, st, en, slots = self._routed_layout(chunk, start, end)
                    v = mv.shards[sh]
                    off = sh * ln
                    # the slab's own positions; a pad place keeps its empty span
                    real = slots.reshape(st.shape) >= 0
                    st = np.where(real, st - off, 0)
                    en = np.where(real, en - off, 0)
                    res = self._search_routed(
                        v, *(upload_async(a, v.device) for a in (g_start - off, st, en)),
                        upload_async(Qpack[slots], v.device), sn, n, k, cap)
                    pending.append(("routed", slots, pack_result(*res)))
                    dispatches += 1
        return counts, dispatches
