"""Sharded partitioned engine: the counterpart of
``hvq_tpu.models.partitioned_sharded``.

Both sorted views are split over the mesh's "d" axis (q = 1), rows padded
to ``row_multiple = n_d · db_tile`` so that every shard holds whole tiles.
Each view is built and held card by card (``_place``): the host sorts
once, each device receives only the rows it holds and gathers, pads and
norms them itself (``index.partition.build_rows``), and shards that share
a device share one block of rows. No tensor of a whole view exists on any
device: a :class:`MeshView` is the whole view's host keys and sizes and
one slab a shard.

* The cat view ((C, T)-sorted) lies in contiguous slabs: a routed group
  (one category's rows) lives inside one slab.
* The time view (T-sorted) is dealt tile by tile (``parallel.mesh.
  deal_rows``): tile t on shard t mod n_d, at local tile t div n_d. A
  start-sorted batch of wide type-2 queries nearly always reaches the
  view's end, so in contiguous slabs every window would fall on the last
  card; dealt, any window of whole tiles is a contiguous range of local
  tiles on every shard, split evenly over them.

Each of the partitioned engine's dispatch kinds runs where its rows live:

* **full** (dense): the shared per-slab stage (``models.batched.slab_scan``)
  on every slab's scan plane, K1 on a card, with the slab's ``oid`` as the
  ids of the sample limit; the candidates are refined on the owning shard
  and turned into ORIGINAL ids there, so the shards' (B, k′) tiles merge
  (``parallel.collectives``) with unique ids and no cross-shard row
  gather; each certificate term takes its minimum over the shards.
* **windowed** wide type-2 batches: the partitioned engine's windows, as
  they are (whole-view tiles, the same buckets and rule). Each shard scans
  its own tiles of the window (``parallel.mesh.dealt_window``), rounded out
  to one local width shared by every shard; rows beside the window fail
  every query's time predicate, so the result stays exact. Then as full:
  original ids, the merge, the per-term minimum.
* **routed** (cat view): a routed group's window lies inside one shard's
  slab: spans that straddle a slab boundary go dense
  (``_routable_extra``), and the groups are packed per slab and
  dispatched on the shard that owns them, the shards' queues drained
  round-robin. Each query is wholly owned by one shard: no merge. Narrow
  type-2 spans are not routed on the dealt time view (``_route_time``):
  they take the windowed or full path (``last_route["time_unrouted"]``).

With ``repair_bins`` > 0 each slab's K1 (or plain packed) scan takes the
in-program bin repair in the slab's own positions (``slab_scan``), and
the slab's residual bin joins the per-term minimum over the shards like
any other term; ``HVQ_CERT_TERMS=1`` keeps the merged certificate's
bitmask per query.

Suspects go through the partitioned engine's ladder: rung 1 this dense
scan at 2R without level 2, rung 2 the per-shard streaming scan and the
merge.

Spans (``utils.timing``): ``mesh/place`` for each view on each device as
it is built (fields ``view``, ``card``, ``rows``, ``bytes``), and for each
windowed batch a ``mesh_window`` counter (``B``, ``row0``, ``ntw``,
``local_tiles``) under ``search/window``, then a ``mesh/window`` span over
every shard's scan, the merge (``mesh/merge``) and the certificate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hvq_tpu_torch.index.partition import (
    PartitionedIndex,
    SortedView,
    build_rows,
    row_bytes,
    view_keys,
)
from hvq_tpu_torch.models import common
from hvq_tpu_torch.models.batched import (
    Slab,
    certificate,
    pack_result,
    slab_scan,
    unpack_query_block,
)
from hvq_tpu_torch.models.device_db import upload_async
from hvq_tpu_torch.models.partitioned import SCAN_IMPLS, PartitionedEngine
from hvq_tpu_torch.ops.scan import choose_bin_top
from hvq_tpu_torch.ops.topk import BIN
from hvq_tpu_torch.parallel.collectives import allgather_topk_merge, min_terms
from hvq_tpu_torch.parallel.mesh import deal_rows, dealt_window, engine_mesh
from hvq_tpu_torch.utils import timing
from hvq_tpu_torch.utils.formats import Dataset
from hvq_tpu_torch.utils.timing import maybe_phase

VIEW_NAMES = ("cat", "time")


@dataclasses.dataclass
class MeshView:
    """A sorted view placed on the mesh: the whole view's host keys
    (``C_key``, ``T_key``) and sizes, and one slab of it a shard
    (``shards``: a SortedView of ``local_n`` rows on the shard's device,
    shards of one device being views of one block). ``dealt``: its tiles
    are dealt round robin, else it lies in contiguous slabs."""

    shards: list
    C_key: np.ndarray
    T_key: np.ndarray
    n: int
    n_pad: int
    db_tile: int
    dealt: bool
    dn_max: float       # the largest ‖d‖² over every shard

    @property
    def num_tiles(self) -> int:
        return self.n_pad // self.db_tile

    @property
    def device(self) -> torch.device:
        """The first shard's device, the mesh's home."""
        return self.shards[0].device

    @property
    def nbytes(self) -> int:
        """Device bytes of every shard together."""
        return sum(v.nbytes for v in self.shards)

    @property
    def device_nbytes(self) -> int:
        """The most bytes of the view that one device holds."""
        held: dict = {}
        for v in self.shards:
            held[v.device] = held.get(v.device, 0) + v.nbytes
        return max(held.values())

    @property
    def row_dtype(self) -> torch.dtype:
        return self.shards[0].row_dtype

    @property
    def bf16_scan(self) -> bool:
        return self.shards[0].bf16_scan


def _slab(v: SortedView, rows: slice = slice(None)) -> Slab:
    """The rows ``rows`` of a shard as one scan's slab (views, no copy)."""
    return Slab(v.Vp[rows], v.scan_V[rows], v.C[rows], v.T[rows], v.d_norms[rows],
                v.oid[rows])


def place_on_mesh(mesh):
    """The placement of a view on ``mesh``'s "d" axis (q = 1), for
    ``PartitionedIndex.build(place=)``: ``place(ds, perm, vid, db_tile=,
    scan_store=, n_pad=, dtype=)`` builds the view of ``ds`` in the row
    order ``perm`` (``vid`` 0 = cat, 1 = time) device by device, each
    device gathering the rows of its shards (contiguous slabs of the cat
    view, the time view's tiles dealt round robin), one ``mesh/place``
    span each, and returns its :class:`MeshView`."""
    devices = list(mesh.devices[0])
    n_d = len(devices)

    def place(ds: Dataset, perm: np.ndarray, vid: int, db_tile: int, scan_store: str,
              n_pad: int, dtype) -> MeshView:
        owned = deal_rows(n_pad, n_d, tile=db_tile if vid == 1 else None)
        keys = view_keys(ds, perm)
        L = n_pad // n_d
        per_row = row_bytes(scan_store, dtype)
        shards: list = [None] * n_d
        blocks = []
        for dev in mesh.distinct():
            js = [j for j, d in enumerate(devices) if d == dev]
            with maybe_phase(None, "mesh/place", view=VIEW_NAMES[vid], card=str(dev),
                             rows=len(js) * L, bytes=len(js) * L * per_row):
                block = build_rows(ds, perm, np.concatenate([owned[j] for j in js]),
                                   db_tile, dev, scan_store=scan_store, dtype=dtype,
                                   keys=keys)
            blocks.append(block)
            for p, j in enumerate(js):
                rows = slice(p * L, (p + 1) * L)
                shards[j] = SortedView(
                    Vp=block.Vp[rows], C=block.C[rows], T=block.T[rows],
                    d_norms=block.d_norms[rows], oid=block.oid[rows],
                    C_key=keys[0], T_key=keys[1], n=ds.n, db_tile=db_tile,
                    V_scan=None if block.V_scan is None else block.V_scan[rows])
        # one sync a device, once every device's build is enqueued
        dn_max = max(b.dn_max for b in blocks)
        return MeshView(shards, keys[0], keys[1], ds.n, n_pad, db_tile,
                        dealt=vid == 1, dn_max=dn_max)

    return place


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
                                       row_multiple=self.n_d * db_tile, dtype=dtype,
                                       place=place_on_mesh(self.mesh))
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
        # the time view is dealt tile by tile: windows, but no routed groups
        self._route_time = False
        # a routed window must fit inside one slab
        self.route_buckets = tuple(c for c in self.route_buckets if c <= self._local_n)

    def _routable_extra(self, start, end) -> np.ndarray:
        # a routed window must live inside ONE slab; spans straddling a
        # boundary take the dense path
        last = np.maximum(end - 1, start)
        return (start // self._local_n) == (last // self._local_n)

    # --- device paths -------------------------------------------------------
    def _sharded_scan(self, slabs: list, db_tile: int, Q: torch.Tensor, sn: int,
                      n: int, k: int, bin_top: int | None, level2: bool, impl: str,
                      phases=None, tile_index=None):
        """The per-shard stage on each slab of ``slabs`` (one a shard, each
        on its device), candidates turned into original ids on their
        shard, the merge and the certificate → home device (ids int32 (B,
        k), suspect bool (B,), dists fp32 (B, k)). ``tile_index``: the
        streaming scan's tiles of each slab (``slab_scan``)."""
        home = self.device
        qbs = {}
        exact, oids, terms = [], [], []
        for slab in slabs:
            dev = slab.Vp.device
            if dev not in qbs:
                qbs[dev] = unpack_query_block(Q.to(dev, non_blocking=True))
            e, pos, t = slab_scan(self, slab, qbs[dev], sn, self.kprime, impl,
                                  bin_top, db_tile, level2, phases, k=k,
                                  tile_index=tile_index)
            exact.append(e)
            oids.append(slab.sid[pos.long()])   # slab positions → original ids
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
                suspect = certificate(f_d, qb.qV, t, self._rel_mm, self._dn_max, k,
                                      self._cert_debug)
        else:
            suspect = torch.zeros(f_d.shape[0], dtype=torch.bool, device=home)
        return f_ids, suspect, f_d

    def _search_full(self, mv: MeshView, Q: torch.Tensor, sn: int, n: int,
                     k: int, bin_top: int | None = None, level2: bool = True,
                     row0: int | None = None, ntw: int | None = None,
                     phases=None):
        """The dense path: the certified packed scan on every slab (the
        plain streaming scan where there is no bin depth), or on each
        shard's local tiles of the window [row0, row0 + ntw·Dt) of a dealt
        view, one local width for every shard, in a ``mesh/window`` span."""
        bin_top = bin_top or self.bin_top
        impl = "stream" if bin_top is None else self.scan_impl
        Dt = mv.db_tile
        if row0 is None:
            return self._sharded_scan([_slab(v) for v in mv.shards], Dt, Q, sn, n, k,
                                      bin_top, level2, impl, phases)
        if not mv.dealt:
            raise ValueError("a window runs on a view dealt tile by tile")
        w, starts = dealt_window(row0 // Dt, ntw, self.n_d, self._local_n // Dt)
        tracer = timing.active_tracer
        if tracer is not None:
            tracer.count("mesh_window", B=int(Q.shape[0]), row0=int(row0), ntw=int(ntw),
                         local_tiles=w)
        slabs = [_slab(v, slice(a * Dt, (a + w) * Dt)) for v, a in zip(mv.shards, starts)]
        with maybe_phase(phases, "mesh/window"):
            return self._sharded_scan(slabs, Dt, Q, sn, n, k, bin_top, level2, impl,
                                      phases)

    def _search_stream(self, mv: MeshView, Q: torch.Tensor, sn: int, n: int, k: int):
        """The ladder's last rung: the per-shard streaming scan and the
        merge. Each shard's tiles are scored many at a time
        (``tile_index``): tile by tile, a shard's 10⁷ rows cost the host
        some 600 steps of a dozen launches each, and the cards wait on it."""
        tiles = np.arange(self._local_n // mv.db_tile)
        return self._sharded_scan([_slab(v) for v in mv.shards], mv.db_tile, Q, sn, n, k,
                                  None, False, "stream", tile_index=tiles)

    def _enqueue_routed(self, mv: MeshView, q_idx, start, end, Qpack, sn, n, k,
                        pending, phases=None) -> tuple[dict, int]:
        """Shard-aware routed packing: groups are packed per slab and
        dispatched on the shard that owns their window, in its own
        coordinates, the shards' queues drained round-robin so shards on
        different devices work at once. The host packer (every slab's
        groups, then every dispatch's layout) runs in one ``routed/pack``
        phase with its ``pack`` counter, as the base class's."""
        ln = self._local_n
        R = self.routed_groups
        slab_of = start[q_idx] // ln
        with maybe_phase(phases, "routed/pack"):
            # {cap: {shard: its groups}}
            by_cap: dict[int, dict] = {}
            for sh in np.unique(slab_of).tolist():
                for cap, groups in self._pack_groups(start, end, q_idx[slab_of == sh]).items():
                    by_cap.setdefault(cap, {})[sh] = groups
            layouts = []
            for cap in sorted(by_cap):
                queues = by_cap[cap]
                for s in range(0, max(map(len, queues.values())), R):
                    for sh in sorted(queues):
                        if s >= len(queues[sh]):
                            continue
                        off = sh * ln
                        g_start, st, en, slots = self._routed_layout(queues[sh][s : s + R],
                                                                     start, end)
                        # the slab's own positions; a pad place keeps its empty span
                        real = slots.reshape(st.shape) >= 0
                        layouts.append((sh, cap, g_start - off, np.where(real, st - off, 0),
                                        np.where(real, en - off, 0), slots))
            counts = {cap: sum(map(len, queues.values())) for cap, queues in by_cap.items()}
            self._count_pack(q_idx.size, counts, len(layouts))
        for sh, cap, g_start, st, en, slots in layouts:
            v = mv.shards[sh]
            res = self._search_routed(
                v, *(upload_async(a, v.device) for a in (g_start, st, en)),
                upload_async(Qpack[slots], v.device), sn, n, k, cap)
            pending.append(("routed", slots, pack_result(*res)))
        return counts, len(layouts)
