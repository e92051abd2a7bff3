"""The port's sorted views (``hvq_tpu_torch.index.partition``) against the
JAX package's (``hvq_tpu.index.partition``) on the same numpy data.

Tolerances: every stored array is exactly equal, except ``d_norms`` when
both packages compute it (rtol 1e-6: a 100-term fp32 sum in another
order); carried across with ``from_arrays``, ``d_norms`` too is exact.
"""

import numpy as np
import pytest
import torch

from hvq_tpu.index import partition as jpart
from hvq_tpu.utils.formats import QuerySet
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch.index import partition as tpart

N, DB_TILE = 3000, 256     # n not a multiple of the tile: padding rows


@pytest.fixture(scope="module")
def ds():
    return generate_dataset(N, seed=1, categories=12)


@pytest.fixture(scope="module")
def indices(ds):
    return (jpart.PartitionedIndex.build(ds, db_tile=DB_TILE),
            tpart.PartitionedIndex.build(ds, db_tile=DB_TILE, device="cpu"))


def _queries(case, ds):
    if case.startswith("type"):
        return generate_queries(60, seed=2, categories=12, types=(int(case[-1]),))
    rng = np.random.default_rng(3)
    m = 40
    if case == "absent_category":     # 0.123456 is no category level
        return QuerySet(qtype=np.array([1, 3] * (m // 2), np.int32),
                        v=np.full(m, 0.123456, np.float32),
                        l=np.full(m, -1.0, np.float32),
                        r=np.full(m, 1.0, np.float32),
                        V=np.zeros((m, 100), np.float32))
    # l and r equal to stored T values: the inclusive bounds must count
    # the rows that hold them
    T = ds.T[rng.integers(0, ds.n, (m, 2))]
    cats = ds.C[rng.integers(0, ds.n, m)]
    return QuerySet(qtype=np.array([2, 3] * (m // 2), np.int32),
                    v=np.where(np.arange(m) % 2, cats, -1).astype(np.float32),
                    l=T.min(1), r=T.max(1), V=np.zeros((m, 100), np.float32))


@pytest.mark.parametrize("case", ["type0", "type1", "type2", "type3",
                                  "absent_category", "stored_T_bounds"])
def test_query_ranges_match_jax_and_count_the_passing_rows(ds, indices, case):
    qs = _queries(case, ds)
    jidx, tidx = indices
    want = jidx.query_ranges(qs.qtype, qs.v, qs.l, qs.r)
    got = tidx.query_ranges(qs.qtype, qs.v, qs.l, qs.r)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    view_id, start, end = got
    for i in range(qs.m):
        t = int(qs.qtype[i])
        passing = np.ones(ds.n, bool)
        if t in (1, 3):
            passing &= ds.C == qs.v[i]
        if t in (2, 3):
            passing &= (ds.T >= qs.l[i]) & (ds.T <= qs.r[i])
        assert view_id[i] == (1 if t == 2 else 0)
        assert end[i] - start[i] == passing.sum(), (case, i)
    assert tidx._time_view is None         # ranges need no time view


def _edge_queries(case, ds):
    """Queries at the edges of the native ranges' table and searches."""
    levels = np.unique(ds.C)
    T = np.sort(ds.T)
    if case == "absent_first_last":     # below, between and above the levels, and on the ends
        v = np.r_[levels[0] - 0.5, (levels[0] + levels[1]) / 2, levels[-1] + 0.5,
                  levels[0], levels[-1], np.inf, -np.inf, np.nan]
        l, r = np.full(v.size, T[10]), np.full(v.size, T[-10])
        qtype = np.r_[[1] * v.size, [3] * v.size]
        v, l, r = (np.r_[x, x] for x in (v, l, r))
    else:
        b = {"l_above_r": (T[2000], T[100]), "nan_bounds": (np.nan, T[500]),
             "nan_upper": (T[500], np.nan), "inf_bounds": (-np.inf, np.inf),
             "inf_reversed": (np.inf, -np.inf), "at_the_ends": (T[0], T[-1]),
             "empty_segment": (T[10], T[-10])}[case]
        v = np.r_[levels, levels[:3] + 0.01] if case == "empty_segment" else levels
        l, r = np.full(v.size, b[0]), np.full(v.size, b[1])
        qtype = np.r_[[3] * v.size, [2] * v.size]
        v, l, r = (np.r_[x, x] for x in (v, l, r))
    m = qtype.size
    return QuerySet(qtype=qtype.astype(np.int32), v=v.astype(np.float32),
                    l=l.astype(np.float32), r=r.astype(np.float32),
                    V=np.zeros((m, 100), np.float32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["absent_first_last", "empty_segment", "l_above_r",
                                  "nan_bounds", "nan_upper", "inf_bounds", "inf_reversed",
                                  "at_the_ends"])
def test_native_ranges_match_jax_on_the_edges(ds, indices, case, dtype):
    """The native pass (the category table, the type-3 segment search, the
    type-2 search) gives the JAX package's ``np.searchsorted`` ranges bit
    for bit: a category absent, below or above every level, or the first
    or last one; type-3 segments left empty; l > r; NaN and ±inf bounds;
    needles in float64 too, which NumPy compares in float64, nudged off
    the float32 keys. Where the predicate is satisfiable (no NaN), the
    range's length, or 0 if it ends before it starts, counts the rows
    that pass."""
    qs = _edge_queries(case, ds)
    if dtype == np.float64:
        qs = QuerySet(qtype=qs.qtype, v=qs.v.astype(dtype), l=qs.l.astype(dtype) - 1e-9,
                      r=qs.r.astype(dtype) + 1e-9, V=qs.V)
    jidx, tidx = indices
    want = jidx.query_ranges(qs.qtype, qs.v, qs.l, qs.r)
    got = tidx.query_ranges(qs.qtype, qs.v, qs.l, qs.r)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    _, start, end = got
    for i in range(qs.m):
        t = int(qs.qtype[i])
        if np.isnan([qs.v[i], qs.l[i], qs.r[i]]).any():
            continue
        passing = ds.C == qs.v[i] if t in (1, 3) else np.ones(ds.n, bool)
        if t in (2, 3):
            passing &= (ds.T >= qs.l[i]) & (ds.T <= qs.r[i])
        assert max(end[i] - start[i], 0) == passing.sum(), (case, i)


def test_native_ranges_hold_keys_with_ties_infinities_and_nan():
    """Keys that hold ties, ±inf and NaN (sorted last, as NumPy sorts
    them): the native ranges equal ``np.searchsorted``'s on the same
    keys, and the category table's bounds equal the runs of C."""
    rng = np.random.default_rng(9)
    ds = generate_dataset(2500, seed=9, categories=6)
    ds.T[:] = np.round(ds.T)                          # ties everywhere
    ds.T[rng.integers(0, ds.n, 30)] = np.inf
    ds.T[rng.integers(0, ds.n, 30)] = -np.inf
    ds.T[rng.integers(0, ds.n, 5)] = np.nan
    ds.C[rng.integers(0, ds.n, 40)] = np.inf
    jidx = jpart.PartitionedIndex.build(ds, db_tile=DB_TILE)
    tidx = tpart.PartitionedIndex.build(ds, db_tile=DB_TILE, device="cpu")
    cats, bounds = tidx.cat_table
    ck = tidx.cat_view.C_key
    np.testing.assert_array_equal(bounds[1:-1], np.flatnonzero(ck[1:] != ck[:-1]) + 1)
    assert (cats == ck[bounds[:-1]]).all() and bounds[-1] == ds.n
    pool = np.r_[np.unique(ds.T), np.nan, 0.5, -0.0]
    m = 400
    qs = QuerySet(qtype=rng.integers(0, 4, m).astype(np.int32),
                  v=rng.choice(np.r_[np.unique(ds.C), 0.3, np.nan], m).astype(np.float32),
                  l=rng.choice(pool, m).astype(np.float32),
                  r=rng.choice(pool, m).astype(np.float32), V=np.zeros((m, 100), np.float32))
    with np.errstate(invalid="ignore"):      # the JAX package's diff of two infinities
        want = jidx.query_ranges(qs.qtype, qs.v, qs.l, qs.r)
    for g, w in zip(tidx.query_ranges(qs.qtype, qs.v, qs.l, qs.r), want):
        np.testing.assert_array_equal(g, w)


def test_tiles_for_ranges_and_pad_tile_list_match_jax():
    rng = np.random.default_rng(4)
    s = rng.integers(0, 2000, 20)
    e = s + rng.integers(0, 300, 20)
    for args in ((s, e, 256, 10), (np.array([5]), np.array([5]), 256, 8)):
        np.testing.assert_array_equal(tpart.tiles_for_ranges(*args),
                                      jpart.tiles_for_ranges(*args))
    for tiles, bucket in ((np.array([1, 2, 3], np.int32), None),
                          (np.array([], np.int32), None),
                          (np.array([4, 9], np.int32), 8)):
        np.testing.assert_array_equal(tpart.pad_tile_list(tiles, bucket),
                                      jpart.pad_tile_list(tiles, bucket))


def _assert_views_equal(tv, jv, exact_norms=False):
    assert (tv.n, tv.db_tile, tv.n_pad) == (jv.n, jv.db_tile, jv.n_pad)
    for name in ("Vp", "C", "T", "oid", "C_key", "T_key"):
        got, want = np.asarray(getattr(tv, name)), np.asarray(getattr(jv, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (tv.V_scan is None) == (jv.V_scan is None)
    if tv.V_scan is not None:
        assert tv.V_scan.dtype == torch.bfloat16
        np.testing.assert_array_equal(tv.V_scan.float().numpy(),
                                      np.asarray(jv.V_scan, np.float32))
    rtol = 0 if exact_norms else 1e-6
    np.testing.assert_allclose(tv.d_norms.numpy(), np.asarray(jv.d_norms),
                               rtol=rtol, atol=0)


@pytest.mark.parametrize("scan_store", ["fp32", "bf16"])
def test_build_and_lazy_time_view_match_jax(ds, scan_store):
    jidx = jpart.PartitionedIndex.build(ds, db_tile=DB_TILE, scan_store=scan_store)
    tidx = tpart.PartitionedIndex.build(ds, db_tile=DB_TILE, scan_store=scan_store, device="cpu")
    _assert_views_equal(tidx.cat_view, jidx.cat_view)
    np.testing.assert_array_equal(tidx.T_sorted, jidx.T_sorted)
    # padding rows: +inf attributes, oid n, zero vectors
    cv = tidx.cat_view
    assert torch.isinf(cv.C[N:]).all() and torch.isinf(cv.T[N:]).all()
    assert (cv.oid[N:] == N).all() and not cv.Vp[N:].any()
    assert tidx._time_view is None and jidx._time_view is None
    _assert_views_equal(tidx.time_view, jidx.time_view)
    assert set(tidx.build_seconds) == {"sort", "cat_view", "time_view"}
    want = cv.n_pad * (128 * 4 + 4 * 4) + (cv.n_pad * 128 * 2 if scan_store == "bf16" else 0)
    assert cv.nbytes == want


@pytest.mark.parametrize("scan_store", ["fp32", "bf16"])
def test_from_arrays_carries_the_jax_index(ds, scan_store):
    jidx = jpart.PartitionedIndex.build(ds, db_tile=DB_TILE, scan_store=scan_store,
                                        lazy_time=False)
    tidx = tpart.PartitionedIndex.from_arrays(
        jidx.cat_view, jidx.T_sorted, time_view=jidx._time_view, device="cpu")
    _assert_views_equal(tidx.cat_view, jidx.cat_view, exact_norms=True)
    _assert_views_equal(tidx.time_view, jidx._time_view, exact_norms=True)
    np.testing.assert_array_equal(tidx.T_sorted, jidx.T_sorted)
    # no time view given: built lazily from ds, or refused without it
    lazy = tpart.PartitionedIndex.from_arrays(jidx.cat_view, jidx.T_sorted, ds=ds, device="cpu")
    assert lazy._scan_store == scan_store
    _assert_views_equal(lazy.time_view, jidx._time_view)
    bare = tpart.PartitionedIndex.from_arrays(jidx.cat_view, jidx.T_sorted, device="cpu")
    with pytest.raises(ValueError):
        bare.time_view


def test_from_arrays_rejects_malformed_views(ds, indices):
    import dataclasses

    jv = indices[0].cat_view
    bad = [dict(oid=np.asarray(jv.oid, np.int64)),
           dict(C=np.asarray(jv.C)[:-1]),
           dict(n=jv.n_pad + 1),
           dict(C_key=np.asarray(jv.C_key)[:-1])]
    for change in bad:
        with pytest.raises(ValueError):
            tpart.SortedView.from_arrays(dataclasses.replace(jv, **change), device="cpu")
    with pytest.raises(ValueError):
        tpart.PartitionedIndex.from_arrays(jv, indices[0].T_sorted[:-1], device="cpu")


def test_perm_cache_is_written_then_read(ds, tmp_path, monkeypatch):
    cache = tmp_path / "perm.npz"
    monkeypatch.setenv("HVQ_PERM_CACHE", str(cache))
    first = tpart.PartitionedIndex.build(ds, db_tile=DB_TILE, device="cpu")
    assert cache.exists()

    def no_sort(*a, **k):
        raise AssertionError("the cached permutation was not used")

    monkeypatch.setattr(tpart.np, "lexsort", no_sort)
    second = tpart.PartitionedIndex.build(ds, db_tile=DB_TILE, device="cpu")
    _assert_views_equal(second.cat_view, first.cat_view, exact_norms=True)
    np.testing.assert_array_equal(second.T_sorted, first.T_sorted)


def test_row_multiple_is_not_ported(ds):
    """row_multiple (the mesh engines' n_d · db_tile padding) is ported
    now: both views of both packages pad to its multiple, equal array for
    array, and a multiple that is not whole tiles raises JAX's ValueError."""
    jidx = jpart.PartitionedIndex.build(ds, db_tile=DB_TILE, row_multiple=8 * DB_TILE)
    tidx = tpart.PartitionedIndex.build(ds, db_tile=DB_TILE, row_multiple=8 * DB_TILE,
                                        device="cpu")
    assert tidx.cat_view.n_pad == 4096 != -(-N // DB_TILE) * DB_TILE
    _assert_views_equal(tidx.cat_view, jidx.cat_view)
    _assert_views_equal(tidx.time_view, jidx.time_view)
    with pytest.raises(ValueError, match="multiple of db_tile"):
        tpart.PartitionedIndex.build(ds, db_tile=DB_TILE, row_multiple=300, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stable_argsort_and_cat_order_equal_numpys(dtype):
    """The packed-word argsort is numpy's stable one: ties in index order,
    −0 equal to +0, negatives below positives; ``cat_order`` is
    ``np.lexsort((T, C))``."""
    rng = np.random.default_rng(5)
    keys = rng.choice(np.array([-2.5, -1.0, -0.0, 0.0, 1e-30, 3.0, 7.25], dtype), 5000)
    keys[::7] = rng.uniform(-3, 3, keys[::7].size)
    np.testing.assert_array_equal(tpart.stable_argsort(keys),
                                  np.argsort(keys, kind="stable"))
    ds = generate_dataset(4000, seed=6, categories=7)
    ds.T[::3] = np.round(ds.T[::3])          # ties within categories
    np.testing.assert_array_equal(tpart.cat_order(ds), np.lexsort((ds.T, ds.C)))
