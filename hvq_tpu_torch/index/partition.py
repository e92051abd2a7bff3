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

``query_ranges`` gives the JAX package's ranges bit for bit through one
native pass (``hvq_tpu_torch.native``, ``routing.cpp``): types 1 and 3 look
their category up in ``cat_table``, the cat view's distinct C keys and
their row bounds, kept on the host at build; type 3 then searches T inside
its category's segment, category by category, and type 2 searches
``T_sorted``, each search branch-free and 16 in lockstep. ``tiles_for_ranges``
and ``pad_tile_list`` are copies of the JAX package's: its module imports
jax at the top.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from hvq_tpu_torch import constants as _c
from hvq_tpu_torch import native
from hvq_tpu_torch.utils import timing
from hvq_tpu_torch.utils.formats import Dataset
from hvq_tpu_torch.models.device_db import (
    PinnedStaging,
    resolve_device,
    storage_dtype,
    upload,
    upload_async,
    upload_scan_plane,
)

# Rows of one host gather and device copy while a view is built (52 MB of
# 100-lane fp32 rows).
_STAGE_ROWS = 1 << 17


@dataclasses.dataclass
class SortedView:
    """One reordered database copy on the device plus host sort keys."""

    # device tensors, rows padded to a multiple of db_tile
    Vp: torch.Tensor        # (n_pad, 128) fp32, or bf16 storage
    C: torch.Tensor         # (n_pad,) fp32, padding rows +inf
    T: torch.Tensor         # (n_pad,) fp32, padding rows +inf
    d_norms: torch.Tensor   # (n_pad,) fp32 ‖d‖² of the fp32 rows (before
    #                         any bf16 storage cast, as the JAX view)
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

    @property
    def device_nbytes(self) -> int:
        """The most bytes of the view that one device holds: all of them."""
        return self.nbytes

    @property
    def row_dtype(self) -> torch.dtype:
        """The rows' storage dtype (``Vp``)."""
        return self.Vp.dtype

    @property
    def bf16_scan(self) -> bool:
        """Whether the view carries the bf16 scan plane."""
        return self.V_scan is not None

    @property
    def dn_max(self) -> float:
        """The largest ‖d‖² of the view (one device sync)."""
        return float(self.d_norms.max())

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


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` as int64. Float32 keys (no NaN)
    go through one sort of unique uint64 words: each key's bits made
    order-preserving (negatives flipped, the sign bit set on the rest, −0
    as +0) above its index, several times faster than the stable sort at
    10⁷ rows and more; other keys through the stable sort itself."""
    keys = np.asarray(keys)
    if keys.dtype != np.float32 or keys.size >= 1 << 32:
        return np.argsort(keys, kind="stable").astype(np.int64)
    bits = (keys + np.float32(0)).view(np.uint32)
    ordered = np.where(bits >> 31, ~bits, bits | np.uint32(1 << 31)).astype(np.uint64)
    words = (ordered << np.uint64(32)) | np.arange(keys.size, dtype=np.uint64)
    words.sort()
    return (words & np.uint64(0xFFFFFFFF)).astype(np.int64)


def cat_order(ds: Dataset) -> np.ndarray:
    """The (C, T)-sorted view's row order: ``np.lexsort((ds.T, ds.C))``
    (C major, T minor, ties in file order) as two stable sorts."""
    by_t = stable_argsort(ds.T)
    return by_t[stable_argsort(np.asarray(ds.C)[by_t])]


def row_bytes(scan_store: str = "fp32", dtype=torch.float32) -> int:
    """Device bytes of one view row: the rows at 128 lanes in ``dtype``,
    the bf16 scan plane where ``scan_store`` is ``"bf16"``, and C, T, ‖d‖²
    and oid."""
    size = torch.empty(0, dtype=storage_dtype(dtype)).element_size()
    return _c.PADDED_DIM * (size + (2 if scan_store == "bf16" else 0)) + 16


def view_keys(ds: Dataset, perm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The host sort keys (C_key, T_key) of the view of ``ds`` in the row
    order ``perm``."""
    return (np.ascontiguousarray(ds.C[perm], np.float32),
            np.ascontiguousarray(ds.T[perm], np.float32))


def build_rows(
    ds: Dataset,
    perm: np.ndarray,
    positions: np.ndarray,
    db_tile: int,
    device: torch.device,
    scan_store: str = "fp32",
    dtype=torch.float32,
    keys: tuple[np.ndarray, np.ndarray] | None = None,
) -> SortedView:
    """The rows at ``positions`` of the view of ``ds`` in the row order
    ``perm``, in that order, on ``device``: a SortedView of
    ``len(positions)`` rows whose host keys (``keys``, default
    :func:`view_keys`) are the whole view's. A position ≥ n is a padding
    row (zero vector, C and T +inf, oid n). The rows are stored in
    ``dtype`` (fp32, or bf16 for the uncertified storage of
    ``dtype=torch.bfloat16``).

    Only these rows reach the device: the host gathers them in view order,
    ``_STAGE_ROWS`` at a time, into two pinned buffers in turn, and each
    chunk's copy is started without waiting for it (``PinnedStaging``), so
    the host gathers the next chunk while the device copies one; nothing
    here waits for the device, so a mesh's cards finish their copies
    while the host gathers the next card's rows. The padding to 128 lanes,
    the norms and the bf16 plane are made on the device, so the peak is
    the view plus a chunk. ``d_norms`` come from the fp32 rows before any
    bf16 cast.
    """
    if scan_store not in ("fp32", "bf16"):
        raise ValueError(f"unknown scan_store {scan_store!r}")
    dtype = storage_dtype(dtype)
    if scan_store == "bf16" and dtype != torch.float32:
        raise ValueError("scan_store='bf16' needs fp32 primary storage")
    n, dim = ds.V.shape
    C_key, T_key = keys if keys is not None else view_keys(ds, perm)
    positions = np.asarray(positions, np.int64)
    rows = positions.shape[0]
    dest = np.flatnonzero(positions < n)            # this block's real rows
    src = perm[positions[dest]]                     # their original rows
    with warnings.catch_warnings():     # a read-only array is only read here
        warnings.simplefilter("ignore", UserWarning)
        V_host = torch.from_numpy(np.ascontiguousarray(ds.V, np.float32))
    Vp = torch.zeros((rows, _c.PADDED_DIM), dtype=torch.float32, device=device)
    d_norms = torch.zeros(rows, dtype=torch.float32, device=device)
    stages = [PinnedStaging(_STAGE_ROWS, dim, device) for _ in range(2)]
    # runs of consecutive destination rows, each filled chunk by chunk
    cuts = np.r_[0, np.flatnonzero(np.diff(dest) != 1) + 1, dest.size]
    turn = 0
    for k0, k1 in zip(cuts[:-1].tolist(), cuts[1:].tolist()):
        for s in range(k0, k1, _STAGE_ROWS):
            e = min(k1, s + _STAGE_ROWS)
            g = stages[turn].gather(V_host, src[s:e])
            turn ^= 1
            d0 = int(dest[s])
            Vp[d0 : d0 + e - s, :dim] = g
            d_norms[d0 : d0 + e - s] = (g * g).sum(dim=1)
            del g
    if dtype != torch.float32:
        Vp = Vp.to(dtype)
    V_scan = Vp.to(torch.bfloat16) if scan_store == "bf16" else None

    def column(keyed, fill):
        out = np.full(rows, fill, dtype=keyed.dtype)
        out[dest] = keyed
        return upload_async(out, device)

    return SortedView(
        Vp=Vp, C=column(C_key[positions[dest]], np.float32(np.inf)),
        T=column(T_key[positions[dest]], np.float32(np.inf)), d_norms=d_norms,
        oid=column(src.astype(np.int32), np.int32(n)),
        C_key=C_key, T_key=T_key, n=n, db_tile=db_tile, V_scan=V_scan,
    )


def build_view(
    ds: Dataset,
    perm: np.ndarray,
    db_tile: int,
    device: torch.device,
    scan_store: str = "fp32",
    n_pad: int | None = None,
    dtype=torch.float32,
) -> SortedView:
    """The whole view of ``ds`` in the row order ``perm`` on one device,
    padded to ``n_pad`` rows (default: whole tiles): :func:`build_rows` of
    every position. Columns are padded to 128 lanes, rows to a multiple of
    ``db_tile``."""
    n = ds.V.shape[0]
    if n_pad is None:
        n_pad = -(-n // db_tile) * db_tile
    view = build_rows(ds, perm, np.arange(n_pad), db_tile, device,
                      scan_store=scan_store, dtype=dtype)
    if device.type == "cuda":
        torch.cuda.synchronize(device)    # build times are device times
    return view


def place_on(device: torch.device):
    """The placement of a whole view on one device: ``place(ds, perm,
    vid, **kw)`` → :func:`build_view` (``vid``: 0 the cat view, 1 the
    time view)."""
    def place(ds, perm, vid, **kw):
        return build_view(ds, perm, device=device, **kw)
    return place


@dataclasses.dataclass
class PartitionedIndex:
    """The two sorted views and the host keys that route to them. A view
    is a SortedView on one device, or what a placement (``_place``, see
    :meth:`build`) made of it, e.g. a mesh engine's slabs."""

    cat_view: SortedView
    T_sorted: np.ndarray                    # (n,) globally sorted T keys
    _time_view: Optional[SortedView] = None
    _ds: Optional[Dataset] = None           # source of the lazy time view
    _db_tile: int = 8192
    _scan_store: str = "fp32"
    _dtype: torch.dtype = torch.float32
    # seconds of each build step: "sort", "cat_view", "time_view"
    build_seconds: dict = dataclasses.field(default_factory=dict)
    # place(ds, perm, vid, db_tile=, scan_store=, n_pad=, dtype=) → view;
    # None: the whole view on the cat view's device (place_on)
    _place: Optional[Callable] = None
    # (distinct C keys float32 (K,), their first rows and n int64 (K + 1,))
    # of the cat view: the partitions of its categories
    cat_table: tuple = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.cat_table = category_table(self.cat_view.C_key)

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
            perm = stable_argsort(self._ds.T)
            # the cat view's rows: a mesh engine's row_multiple included
            place = self._place or place_on(self.device)
            self._time_view = place(
                self._ds, perm, 1, db_tile=self._db_tile,
                scan_store=self._scan_store, n_pad=self.cat_view.n_pad,
                dtype=self._dtype,
            )
            self.build_seconds["time_view"] = time.perf_counter() - t0
        return self._time_view

    @classmethod
    def build(cls, ds: Dataset, db_tile: int = 8192,
              device: torch.device | str = "cuda", scan_store: str = "fp32",
              row_multiple: int | None = None, dtype=torch.float32,
              place: Callable | None = None):
        """Sort on the host and build the cat view; the time view is built
        on first use (:attr:`time_view`), with the cat view's rows.

        ``row_multiple`` (default ``db_tile``): pad the rows to its multiple
        instead; the mesh engines need ``n_d · db_tile``, so every shard
        holds whole tiles of both views. ``dtype``: the views' row storage
        (``torch.bfloat16``: rounded rows, ‖d‖² from the fp32 ones).
        ``place`` (default :func:`place_on` ``device``) builds each view
        from its permutation, ``place(ds, perm, vid, db_tile=, scan_store=,
        n_pad=, dtype=)``: a mesh engine's places it card by card.

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
            cat_perm = cat_order(ds)
            T_sorted = np.sort(ds.T).astype(np.float32)
            if pc:
                tmp = f"{pc}.tmp{os.getpid()}"
                np.savez(tmp, n=ds.n, cat_perm=cat_perm, T_sorted=T_sorted)
                try:
                    os.replace(tmp + ".npz", pc)
                except OSError:
                    pass
        t1 = time.perf_counter()
        place = place or place_on(device)
        out = cls(
            cat_view=place(ds, cat_perm, 0, db_tile=db_tile, scan_store=scan_store,
                           n_pad=-(-ds.n // rm) * rm, dtype=dtype),
            T_sorted=T_sorted, _ds=ds, _db_tile=db_tile, _scan_store=scan_store,
            _dtype=storage_dtype(dtype), _place=place,
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

    # ---- host-side range resolution ---------------------------------------
    def query_ranges(
        self,
        qtype: np.ndarray,
        v: np.ndarray,
        l: np.ndarray,
        r: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per query: (view_id, start, end) — 0 = cat_view, 1 = time_view.

        The range is the exact candidate span in the chosen view; every row
        outside it fails the predicate. Each equals ``np.searchsorted`` on
        the host keys (``C_key``, then ``T_key`` inside the category;
        ``T_sorted``), as the JAX package's; the time view is not built.
        Under a tracer, a ``route`` counter: ``queries``, and those resolved
        by the category table (``table``), by the type-3 segment search
        (``segment``) and by the type-2 search (``time``).
        """
        cv = self.cat_view
        view, start, end, (table, segment, n_time) = native.query_ranges(
            qtype, v, l, r, *self.cat_table, cv.T_key, self.T_sorted)
        tracer = timing.active_tracer
        if tracer is not None:
            tracer.count("route", queries=int(view.size), table=table, segment=segment,
                         time=n_time)
        return view, start, end


def category_table(C_key: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The distinct values of the sorted keys ``C_key`` (float32 (K,)) and
    the row where each one's run starts, then n (int64 (K + 1,)): a key's
    ``np.searchsorted`` bounds are ``bounds[np.searchsorted(cats, ...)]``."""
    C_key = np.asarray(C_key)
    cuts = np.flatnonzero(C_key[1:] != C_key[:-1]) + 1
    bounds = np.r_[0, cuts, C_key.size].astype(np.int64)
    return np.ascontiguousarray(C_key[bounds[:-1]], np.float32), bounds


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
