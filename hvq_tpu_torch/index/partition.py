"""Category-partitioned and timestamp-sorted views: the counterpart of
``hvq_tpu.index.partition``.

The database is reordered so that each query's predicate maps to one
contiguous row range of a sorted view, found by binary search on host
sort keys; only that range (or the tiles around it) is scanned.

* ``cat_view``: rows sorted by (C, T). A type-1 query (``C == v``) is the
  partition of ``v``; a type-3 query narrows that partition by binary
  search on its sorted timestamps; a type-0 query spans the whole view.
* ``time_view``: rows sorted by T. A type-2 query (``l <= T <= r``) is one
  contiguous range. It is a second copy of the database on the device, so
  it is built on first use.

Building an index never looks at query vectors: it is a permutation of the
database plus host sort keys. Each row carries its original id in ``oid``,
so results and the reference's sample limit (``oid < sn``, file order)
stay in the original id space.

The host functions (``query_ranges``, ``tiles_for_ranges``,
``pad_tile_list``) are copies of the JAX package's: its module imports jax
at the top.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from hvq_tpu_torch import constants as _c
from hvq_tpu_torch.utils.formats import Dataset
from hvq_tpu_torch.models.device_db import resolve_device, upload, upload_scan_plane

# Row chunks of the on-device permutation gather: the temporary of one
# chunk is 1/8 of the database, so the peak is source + output.
_GATHER_CHUNKS = 8


@dataclasses.dataclass
class SortedView:
    """One reordered database copy on the device plus host sort keys."""

    # device tensors, rows padded to a multiple of db_tile
    Vp: torch.Tensor        # (n_pad, 128) fp32
    C: torch.Tensor         # (n_pad,) fp32, padding rows +inf
    T: torch.Tensor         # (n_pad,) fp32, padding rows +inf
    d_norms: torch.Tensor   # (n_pad,) fp32 ‖d‖² of the fp32 rows
    oid: torch.Tensor       # (n_pad,) int32 original ids, padding rows n
    # host sort keys in view order
    C_key: np.ndarray       # (n,)
    T_key: np.ndarray       # (n,)
    n: int
    db_tile: int
    # the bf16 scan plane (scan_store="bf16"): only the selection scan
    # reads it; refinement gathers the fp32 Vp rows
    V_scan: Optional[torch.Tensor] = None

    @property
    def n_pad(self) -> int:
        return self.Vp.shape[0]

    @property
    def num_tiles(self) -> int:
        return self.n_pad // self.db_tile

    @property
    def device(self) -> torch.device:
        return self.Vp.device

    @property
    def scan_V(self) -> torch.Tensor:
        """The plane the selection scan reads (bf16 if present, else Vp)."""
        return self.V_scan if self.V_scan is not None else self.Vp

    @property
    def nbytes(self) -> int:
        """Device bytes the view holds, the bf16 plane included."""
        return sum(t.numel() * t.element_size()
                   for t in (self.Vp, self.V_scan, self.C, self.T,
                             self.d_norms, self.oid) if t is not None)

    @classmethod
    def from_arrays(cls, src, device: torch.device | str = "cuda") -> "SortedView":
        """A view from arrays another engine already laid out.

        ``src`` has a SortedView's attributes (``Vp``, ``V_scan``, ``C``,
        ``T``, ``d_norms``, ``oid``, ``C_key``, ``T_key``, ``n``,
        ``db_tile``), e.g. a view of the JAX package's index; each array
        goes through ``np.asarray``, so both packages search identical
        stored state.
        """
        device = resolve_device(device)
        Vp = np.asarray(src.Vp, np.float32)
        n, db_tile = int(src.n), int(src.db_tile)
        if Vp.ndim != 2 or Vp.shape[1] != _c.PADDED_DIM:
            raise ValueError(f"Vp must be (n_pad, {_c.PADDED_DIM}), got {Vp.shape}")
        n_pad = Vp.shape[0]
        if n_pad % db_tile or not 0 < n <= n_pad:
            raise ValueError(f"n_pad {n_pad} must cover n {n} in {db_tile}-row tiles")
        cols = [np.asarray(x, np.float32) for x in (src.C, src.T, src.d_norms)]
        oid = np.asarray(src.oid)
        if any(x.shape != (n_pad,) for x in (*cols, oid)):
            raise ValueError(f"C, T, d_norms, oid must be ({n_pad},)")
        if oid.dtype != np.int32:
            raise ValueError(f"oid must be int32, got {oid.dtype}")
        keys = [np.ascontiguousarray(src.C_key, np.float32),
                np.ascontiguousarray(src.T_key, np.float32)]
        if any(x.shape != (n,) for x in keys):
            raise ValueError(f"C_key, T_key must be ({n},)")
        scan = (None if src.V_scan is None
                else upload_scan_plane(src.V_scan, Vp.shape, device))
        C, T, dn = (upload(x, device) for x in cols)
        return cls(Vp=upload(Vp, device), C=C, T=T, d_norms=dn,
                   oid=upload(oid, device), C_key=keys[0], T_key=keys[1],
                   n=n, db_tile=db_tile, V_scan=scan)


def _build_view(
    ds: Dataset,
    perm: np.ndarray,
    db_tile: int,
    device: torch.device,
    scan_store: str = "fp32",
    n_pad: int | None = None,
) -> SortedView:
    """The view of ``ds`` in the row order ``perm``, padded to ``n_pad``
    rows (default: whole tiles).

    The raw vectors are uploaded (pinned) in original row order; the
    permutation gather, the padding and the norms run on the device,
    in ``_GATHER_CHUNKS`` row chunks into one preallocated zeroed output,
    so the peak is the source plus the output (the JAX comment at
    ``partition.py:131-138`` explains why a fused gather is not used).
    Columns are padded to 128 lanes, rows to a multiple of ``db_tile``;
    ``d_norms`` come from the fp32 rows before any bf16 cast.
    """
    if scan_store not in ("fp32", "bf16"):
        raise ValueError(f"unknown scan_store {scan_store!r}")
    n, dim = ds.V.shape
    if n_pad is None:
        n_pad = -(-n // db_tile) * db_tile
    V_dev = upload(np.asarray(ds.V, np.float32), device)
    idx = upload(perm.astype(np.int64), device)
    Vp = torch.zeros((n_pad, _c.PADDED_DIM), dtype=torch.float32, device=device)
    d_norms = torch.zeros(n_pad, dtype=torch.float32, device=device)
    bounds = np.linspace(0, n, _GATHER_CHUNKS + 1).astype(np.int64)
    for s, e in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        g = V_dev.index_select(0, idx[s:e])
        Vp[s:e, :dim] = g
        d_norms[s:e] = (g * g).sum(dim=1)
        del g
    del V_dev, idx
    V_scan = Vp.to(torch.bfloat16) if scan_store == "bf16" else None

    def _pad(a, fill):
        out = np.full(n_pad, fill, dtype=a.dtype)
        out[:n] = a
        return upload(out, device)

    C_key = np.ascontiguousarray(ds.C[perm], np.float32)
    T_key = np.ascontiguousarray(ds.T[perm], np.float32)
    view = SortedView(
        Vp=Vp, C=_pad(C_key, np.float32(np.inf)),
        T=_pad(T_key, np.float32(np.inf)), d_norms=d_norms,
        oid=_pad(perm.astype(np.int32), np.int32(n)),
        C_key=C_key, T_key=T_key, n=n, db_tile=db_tile, V_scan=V_scan,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)    # build times are device times
    return view


@dataclasses.dataclass
class PartitionedIndex:
    cat_view: SortedView
    T_sorted: np.ndarray                    # (n,) globally sorted T keys
    _time_view: Optional[SortedView] = None
    _ds: Optional[Dataset] = None           # source of the lazy time view
    _db_tile: int = 8192
    _scan_store: str = "fp32"
    # seconds of each build step: "sort", "cat_view", "time_view"
    build_seconds: dict = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.cat_view.device

    @property
    def time_view(self) -> SortedView:
        """The T-sorted view, built on first use.

        Only type-2 queries use it, so building it eagerly would cost a
        second database copy on the device for a path many workloads never
        take. Range widths come from the host keys ``T_sorted`` without it.
        """
        if self._time_view is None:
            if self._ds is None:
                raise ValueError(
                    "time view not materialized and lazy source unavailable"
                )
            t0 = time.perf_counter()
            perm = np.argsort(self._ds.T, kind="stable").astype(np.int64)
            # the cat view's rows: a mesh engine's row_multiple included
            self._time_view = _build_view(
                self._ds, perm, self._db_tile, self.device,
                scan_store=self._scan_store, n_pad=self.cat_view.n_pad,
            )
            self.build_seconds["time_view"] = time.perf_counter() - t0
        return self._time_view

    @classmethod
    def build(cls, ds: Dataset, db_tile: int = 8192,
              device: torch.device | str = "cuda", scan_store: str = "fp32",
              row_multiple: int | None = None):
        """Sort on the host and build the cat view; the time view is built
        on first use (:attr:`time_view`), with the cat view's rows.

        ``row_multiple`` (default ``db_tile``): pad the rows to its multiple
        instead; the mesh engines need ``n_d · db_tile``, so every shard
        holds whole tiles of both views.

        ``HVQ_PERM_CACHE=<path.npz>`` keeps the host sort products (the
        (C, T) permutation and ``T_sorted``) across processes; the device
        arrays are rebuilt regardless.
        """
        rm = row_multiple or db_tile
        if rm % db_tile:
            raise ValueError("row_multiple must be a multiple of db_tile")
        device = resolve_device(device)
        t0 = time.perf_counter()
        pc = os.environ.get("HVQ_PERM_CACHE")
        cat_perm = T_sorted = None
        if pc and os.path.exists(pc):
            z = np.load(pc, mmap_mode="r")
            if int(z["n"]) == ds.n:
                cat_perm = np.asarray(z["cat_perm"])
                T_sorted = np.asarray(z["T_sorted"])
        if cat_perm is None:
            cat_perm = np.lexsort((ds.T, ds.C)).astype(np.int64)  # C major, T minor
            T_sorted = np.sort(ds.T).astype(np.float32)
            if pc:
                tmp = f"{pc}.tmp{os.getpid()}"
                np.savez(tmp, n=ds.n, cat_perm=cat_perm, T_sorted=T_sorted)
                try:
                    os.replace(tmp + ".npz", pc)
                except OSError:
                    pass
        t1 = time.perf_counter()
        out = cls(
            cat_view=_build_view(ds, cat_perm, db_tile, device,
                                 scan_store=scan_store,
                                 n_pad=-(-ds.n // rm) * rm),
            T_sorted=T_sorted, _ds=ds, _db_tile=db_tile, _scan_store=scan_store,
        )
        out.build_seconds.update(sort=t1 - t0, cat_view=time.perf_counter() - t1)
        return out

    @classmethod
    def from_arrays(cls, cat_view, T_sorted, time_view=None,
                    ds: Dataset | None = None,
                    device: torch.device | str = "cuda") -> "PartitionedIndex":
        """An index from views another engine already laid out (see
        :meth:`SortedView.from_arrays`), e.g. ``jax_index.cat_view``,
        ``jax_index.T_sorted`` and ``jax_index._time_view``. With no
        ``time_view``, ``ds`` is the source of the lazy one."""
        cat = SortedView.from_arrays(cat_view, device)
        tv = None if time_view is None else SortedView.from_arrays(time_view, device)
        if tv is not None and (tv.n, tv.n_pad, tv.db_tile) != (cat.n, cat.n_pad, cat.db_tile):
            raise ValueError("the time view's shape differs from the cat view's")
        T_sorted = np.ascontiguousarray(T_sorted, np.float32)
        if T_sorted.shape != (cat.n,):
            raise ValueError(f"T_sorted must be ({cat.n},)")
        return cls(cat_view=cat, T_sorted=T_sorted, _time_view=tv, _ds=ds,
                   _db_tile=cat.db_tile,
                   _scan_store="fp32" if cat.V_scan is None else "bf16")

    # ---- host-side range resolution (binary search on sort keys) --------
    def query_ranges(
        self,
        qtype: np.ndarray,
        v: np.ndarray,
        l: np.ndarray,
        r: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per query: (view_id, start, end) — 0 = cat_view, 1 = time_view.

        The range is the exact candidate span in the chosen view; every row
        outside it fails the predicate.
        """
        m = qtype.shape[0]
        view = np.where(qtype == 2, 1, 0).astype(np.int32)
        start = np.zeros(m, np.int64)
        end = np.full(m, self.cat_view.n, np.int64)

        cv = self.cat_view
        is1 = qtype == 1
        is2 = qtype == 2
        is3 = qtype == 3
        if is1.any() or is3.any():
            sel = is1 | is3
            s = np.searchsorted(cv.C_key, v[sel], side="left")
            e = np.searchsorted(cv.C_key, v[sel], side="right")
            start[sel], end[sel] = s, e
        if is3.any():
            # narrow each partition by its sorted timestamps, grouped by
            # category: one batched searchsorted per distinct category
            idx3 = np.nonzero(is3)[0]
            v3 = v[idx3]
            order = np.argsort(v3, kind="stable")
            sidx = idx3[order]
            vs = v3[order]
            b = np.r_[0, np.flatnonzero(np.diff(vs)) + 1, vs.size]
            for g0, g1 in zip(b[:-1], b[1:]):
                g = sidx[g0:g1]
                s, e = start[g[0]], end[g[0]]
                seg = cv.T_key[s:e]
                start[g] = s + np.searchsorted(seg, l[g], side="left")
                end[g] = s + np.searchsorted(seg, r[g], side="right")
        if is2.any():
            # from the host keys alone: does not build the time view
            start[is2] = np.searchsorted(self.T_sorted, l[is2], side="left")
            end[is2] = np.searchsorted(self.T_sorted, r[is2], side="right")
        return view, start, end


def tiles_for_ranges(
    start: np.ndarray, end: np.ndarray, db_tile: int, num_tiles: int
) -> np.ndarray:
    """Union of tile indices overlapping any [start, end) range, sorted.

    Empty ranges contribute nothing; the result may be empty.
    """
    mask = np.zeros(num_tiles, dtype=bool)
    for s, e in zip(start, end):
        if e > s:
            mask[s // db_tile : (e - 1) // db_tile + 1] = True
    return np.nonzero(mask)[0].astype(np.int32)


def pad_tile_list(tiles: np.ndarray, bucket: int | None = None) -> np.ndarray:
    """Pad a tile list to a power-of-two bucket with -1 (skipped tiles)."""
    count = max(int(tiles.shape[0]), 1)
    size = bucket or (1 << (count - 1).bit_length())
    out = np.full(size, -1, np.int32)
    out[: tiles.shape[0]] = tiles
    return out
