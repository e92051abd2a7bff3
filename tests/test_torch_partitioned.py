"""The port's partitioned engine on the CPU against the oracle and the JAX
``PartitionedEngine``, plus the two shared-code repairs it needs.

The contract is the JAX package's: recomputed result distances within
0.002 of the oracle's (tests/conftest.py:assert_results_match) and
recall@100 = 1.0. Against the JAX engine both sides search the SAME
stored state, carried across with ``PartitionedIndex.from_arrays``; the
JAX engine runs its CPU scan (``xla_packed``), the port K1's plain
version, both the 3-pass bf16 split in the axis1 layout.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvq_tpu.models import common as jcommon
from hvq_tpu.models.batched import BatchedEngine as JaxBatchedEngine
from hvq_tpu.models.batched import unbundle_ids
from hvq_tpu.models.oracle import search_oracle
from hvq_tpu.models.partitioned import PartitionedEngine as JaxPartitionedEngine
from hvq_tpu.utils import formats
from hvq_tpu.utils.compare import recall_at_k
from hvq_tpu.utils.formats import QuerySet
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch import get_engine
from hvq_tpu_torch.index.partition import PartitionedIndex
from hvq_tpu_torch.models import batched as tbatched
from hvq_tpu_torch.models import common as tcommon
from hvq_tpu_torch.models.batched import BatchedEngine
from hvq_tpu_torch.models.device_db import DeviceDB
from hvq_tpu_torch.models.partitioned import PartitionedEngine
from hvq_tpu_torch.ops import kernels

from conftest import assert_results_match

RTOL_FP32 = 128 * 2.0 ** -24   # refined fp32 distances: summation order only


def _exact(ds, qs, eng, sample_proportion=1.0):
    oids, odists = search_oracle(ds, qs, sample_proportion=sample_proportion)
    ids, dists = eng.search(qs, sample_proportion=sample_proportion)
    assert ids.dtype == np.uint32 and dists.dtype == np.float32
    assert ids.shape == dists.shape == (qs.m, 100)
    assert_results_match(ds, qs, ids, dists, oids, odists)
    assert recall_at_k(ids, oids, dists, odists) == 1.0
    return ids, dists


def _type2(m, seed, lo, hi, width=None):
    """m type-2 queries with l uniform in [lo, hi) and r = l + width, or r
    uniform in [l, 4) (up to T's maximum) when width is None."""
    rng = np.random.default_rng(seed)
    l = rng.uniform(lo, hi, m).astype(np.float32)
    r = l + width if width is not None else rng.uniform(l, 4.0)
    return QuerySet(qtype=np.full(m, 2, np.int32), v=np.full(m, -1.0, np.float32),
                    l=l, r=r.astype(np.float32),
                    V=rng.uniform(-6, 6, (m, 100)).astype(np.float32))


def _concat(*sets):
    return QuerySet(**{f.name: np.concatenate([getattr(s, f.name) for s in sets])
                       for f in dataclasses.fields(QuerySet)})


def _pair(ds, **kw):
    """The JAX engine and the port's engine on the JAX engine's index."""
    jeng = JaxPartitionedEngine(ds, **kw)
    ji = jeng.index
    idx = PartitionedIndex.from_arrays(ji.cat_view, ji.T_sorted,
                                       time_view=ji._time_view, ds=ds, device="cpu")
    kw.pop("db_tile", None)
    eng = PartitionedEngine(ds, index=idx, **kw, device="cpu")
    assert (eng.bin_top, eng.kprime, eng.route_buckets, eng.certified) == (
        jeng.bin_top, jeng.kprime, jeng.route_buckets, jeng.certified)
    return jeng, eng


# --- repairs of shared code ---------------------------------------------------

def test_scan_database_masks_the_sample_limit_on_original_ids():
    """A reversed oid with sn = n/2 keeps exactly the rows whose ORIGINAL
    id is < sn (positions ≥ n/2), as the JAX scan_database(oid_tiles=)."""
    rng = np.random.default_rng(50)
    n_pad, Dt, B, kp = 2048, 512, 6, 128
    Vp = rng.standard_normal((n_pad, 128)).astype(np.float32)
    C = rng.integers(0, 3, n_pad).astype(np.float32)
    T = rng.uniform(-3, 3, n_pad).astype(np.float32)
    dn = (Vp * Vp).sum(1).astype(np.float32)
    oid = np.arange(n_pad)[::-1].astype(np.int32)
    qV = rng.standard_normal((B, 128)).astype(np.float32)
    qtype = np.array([0, 1, 2, 3, 0, 1])
    v = rng.integers(0, 3, B).astype(np.float32)
    l = np.full(B, -2.0, np.float32)
    r = np.full(B, 1.0, np.float32)
    ac, at = np.isin(qtype, (1, 3)), np.isin(qtype, (2, 3))
    sn = n_pad // 2
    qb = tcommon.QueryBatch(*map(torch.from_numpy, (qV, ac, v, at, l, r)))
    got_s, got_p = tcommon.scan_database(
        *map(torch.from_numpy, (Vp, C, T, dn)), qb, sn, kprime=kp, db_tile=Dt,
        oid=torch.from_numpy(oid))
    nt = n_pad // Dt
    jqb = jcommon.QueryBatch(*map(jnp.asarray, (qV, ac, v, at, l, r)))
    want_s, want_p = jcommon.scan_database(
        (jnp.asarray(Vp).reshape(nt, Dt, 128), *(jnp.asarray(x).reshape(nt, Dt)
                                                 for x in (C, T, dn))),
        jqb, jnp.int32(sn), kp, Dt, oid_tiles=jnp.asarray(oid).reshape(nt, Dt))
    got_s, got_p = got_s.numpy(), got_p.numpy()
    want_s, want_p = np.asarray(want_s), np.asarray(want_p)
    np.testing.assert_array_equal(np.isfinite(got_s), np.isfinite(want_s))
    fin = np.isfinite(got_s)
    np.testing.assert_allclose(got_s[fin], want_s[fin], rtol=1e-5, atol=1e-3)
    for b in range(B):
        passing = (oid < sn) & (~ac[b] | (C == v[b])) & (~at[b] | ((T >= l[b]) & (T <= r[b])))
        assert fin[b].sum() == min(kp, passing.sum())
        assert set(got_p[b][fin[b]]) == set(want_p[b][np.isfinite(want_s[b])])
        assert (got_p[b][fin[b]] >= sn).all()          # original id < sn
    # the position-based test (no oid) keeps the other half instead
    s0, p0 = tcommon.scan_database(*map(torch.from_numpy, (Vp, C, T, dn)), qb, sn,
                                   kprime=kp, db_tile=Dt)
    assert (p0.numpy()[np.isfinite(s0.numpy())] < sn).all()


def test_batched_level2_gate_reads_l2_min_w(monkeypatch):
    """W = 16384 passes the fixed axis1 gate; l2_min_w above it turns
    level 2 off, and the answer still equals the JAX engine's with the
    same l2_min_w on the same stored state."""
    ds = generate_dataset(65536, seed=13, categories=20)
    qs = generate_queries(32, seed=14, categories=20)
    jeng = JaxBatchedEngine(ds, db_tile=512, query_batch=32, bin_top=32,
                            scan_impl="xla_packed", l2_min_w=16385)
    jdb = jeng.db
    db = DeviceDB.from_arrays(np.asarray(jdb.Vp), np.asarray(jdb.C),
                              np.asarray(jdb.T), np.asarray(jdb.d_norms),
                              jdb.n, jdb.db_tile, device="cpu")
    calls = []
    orig = tbatched.binned_stream_topk
    monkeypatch.setattr(tbatched, "binned_stream_topk",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    eng = BatchedEngine(ds, query_batch=32, bin_top=32, device_db=db,
                        l2_min_w=16385, device="cpu")
    ids, dists = _exact(ds, qs, eng)
    assert not calls
    jids, jdists = jeng.search(qs)
    assert_results_match(ds, qs, ids, dists, jids, jdists)
    np.testing.assert_allclose(dists, jdists, rtol=RTOL_FP32)
    BatchedEngine(ds, query_batch=32, bin_top=32, device_db=db, device="cpu").search(qs)
    assert calls                       # the default gate does take it


# --- pieces against the JAX engine -------------------------------------------

def test_finalize_with_oid_matches_jax_finalize_view():
    """Refine view rows, map to original ids, pad from the tail, sort; some
    queries hold fewer than k finite candidates (tail pads)."""
    rng = np.random.default_rng(51)
    n, n_pad, B, kp, k = 900, 1024, 5, 128, 100
    V = rng.uniform(-6, 6, (n, 100)).astype(np.float32)
    perm = rng.permutation(n)
    Vp = np.zeros((n_pad, 128), np.float32)
    Vp[:n, :100] = V[perm]
    oid = np.r_[perm, np.full(n_pad - n, n)].astype(np.int32)
    tail = tcommon.tail_block_np(V, t=kp)
    qV = np.zeros((B, 128), np.float32)
    qV[:, :100] = rng.uniform(-6, 6, (B, 100))
    pos = np.stack([rng.choice(n, kp, replace=False) for _ in range(B)]).astype(np.int32)
    scores = rng.uniform(0, 100, (B, kp)).astype(np.float32)
    scores[1, 30:] = np.inf                       # 30 candidates: 70 pads
    scores[3, :] = np.inf                         # none: all pads
    z = np.zeros(B, bool)
    f = np.zeros(B, np.float32)
    qb = tcommon.QueryBatch(torch.from_numpy(qV), *map(torch.from_numpy, (z, f, z, f, f)))
    got_i, got_d = tcommon.finalize(
        torch.from_numpy(scores), torch.from_numpy(pos), torch.from_numpy(Vp),
        qb, n, k, torch.from_numpy(tail), oid=torch.from_numpy(oid))
    jqb = jcommon.QueryBatch(*map(jnp.asarray, (qV, z, f, z, f, f)))
    want_i, want_d = jcommon.finalize_view(
        jnp.asarray(scores), jnp.asarray(pos), jnp.asarray(Vp), jnp.asarray(oid),
        jnp.asarray(tail), jqb, jnp.int32(n), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=RTOL_FP32)
    assert set(got_i.numpy()[3]) == set(range(n - k, n))


@pytest.fixture(scope="module")
def routed_pair():
    ds = generate_dataset(20000, seed=9, categories=50)
    jeng, eng = _pair(ds, db_tile=1024, query_batch=32,
                      route_buckets=(512, 2048), route_group=4)
    qs = generate_queries(300, seed=10, categories=50, types=(1, 2, 3))
    return ds, qs, jeng, eng


def test_pack_groups_matches_jax_and_holds_its_invariants(routed_pair):
    ds, qs, jeng, eng = routed_pair
    view_id, start, end = eng.index.query_ranges(qs.qtype, qs.v, qs.l, qs.r)
    span = end - start
    routable = (span <= eng.route_buckets[-1]) & (span < ds.n)
    q_idx = np.nonzero(routable & (view_id == 0))[0]
    assert q_idx.size > 50
    by_cap = eng._pack_groups(start, end, q_idx)
    want = jeng._pack_groups(start, end, q_idx)
    norm = lambda d: {c: [(int(g), [int(q) for q in m]) for g, m in v]
                      for c, v in d.items()}
    assert norm(by_cap) == norm(want)
    seen = []
    for cap, groups in by_cap.items():
        assert cap in eng.route_buckets
        for g_start, members in groups:
            assert 1 <= len(members) <= eng.route_group
            for q in members:
                assert g_start <= start[q] and end[q] <= g_start + cap
            seen.extend(members)
    assert sorted(seen) == sorted(q_idx.tolist())


def _jax_groups(start, end, q_idx, caps, group):
    """The JAX engine's packer on its own, with these caps and group size."""
    host = types.SimpleNamespace(route_buckets=tuple(caps), route_group=group)
    return JaxPartitionedEngine._pack_groups(host, start, end, q_idx)


def _norm(by_cap):
    return {int(c): [(int(g), [int(q) for q in m]) for g, m in groups]
            for c, groups in by_cap.items()}


def _layout_of(groups, start, end, group):
    """The dispatch layout of a list of (g_start, members), place by place."""
    g_start = np.array([g for g, _ in groups], np.int64)
    st = np.zeros((len(groups), group), np.int64)
    en = np.zeros_like(st)
    slots = np.full(len(groups) * group, -1, np.int64)
    for gi, (_, members) in enumerate(groups):
        for qi, q in enumerate(members):
            st[gi, qi], en[gi, qi], slots[gi * group + qi] = start[q], end[q], q
    return g_start, st, en, slots


def _spans(case, rng):
    """(start, end) of each packer path over caps (256, 1024, 4096): a
    group extended within its cap, closed full, escalated twice while under
    half full, closed at half full, closed at the widest cap, closed where
    the next cap is too narrow, a window left unaligned where aligning it
    would pass the widest cap, spans that end before they start, and a
    random mix of them all."""
    def pairs(*p):
        return (np.array([a for a, _ in p], np.int64), np.array([b for _, b in p], np.int64))
    if case == "extend":
        return pairs(*[(s, s + 10) for s in range(10)])
    if case == "full":
        return pairs(*[(5, 20)] * 40)
    if case == "escalate":
        return pairs((0, 100), (0, 600), (0, 2000), (10, 50))
    if case == "half_full_closes":      # under half full escalates, half full closes
        return pairs(*[(0, 100)] * 7, (1, 600), *[(10000, 10100)] * 8, (10001, 10600))
    if case == "widest_closes":
        return pairs((0, 3000), (100, 4200), (200, 300))
    if case == "next_too_narrow":
        return pairs((0, 100), (0, 2000), (0, 100))
    if case == "unaligned":
        return pairs((130, 130 + 4095), (129, 200), (300, 4300))
    if case == "reversed":
        return pairs((500, 400), (500, 300), (10, 9), (9000, 10))
    start = rng.integers(0, 20000, 300)
    start[::3] = start[::3] // 1000 * 1000                       # ties
    return start, start + rng.integers(-50, 4000, 300)


@pytest.mark.parametrize("group", [1, 16])
@pytest.mark.parametrize("case", ["extend", "full", "escalate", "half_full_closes",
                                  "widest_closes", "next_too_narrow", "unaligned",
                                  "reversed", "random"])
def test_native_groups_and_layouts_match_jax_on_every_path(routed_pair, case, group):
    """The native packer's groups equal the JAX engine's on each of its
    paths, caps (256, 1024, 4096), route_group 1 and 16, the routed
    queries given in any order; each dispatch's layout holds them place by
    place, -1 and an empty span in every unused place."""
    eng = routed_pair[3]
    caps = (256, 1024, 4096)
    start, end = _spans(case, np.random.default_rng(7))
    q_idx = np.random.default_rng(8).permutation(start.size)
    host = types.SimpleNamespace(route_buckets=caps, route_group=group)
    got = PartitionedEngine._pack_groups(host, start, end, q_idx)
    want = _jax_groups(start, end, q_idx, caps, group)
    assert _norm(got) == _norm(want)
    assert list(got) == list(want)          # caps in the order the walk first closed them
    if case == "escalate" and group == 16:        # one group, escalated to 4096
        ((g, members),) = _norm(got)[4096]
        assert len(got) == 1 and g == 0 and sorted(members) == [0, 1, 2, 3]
    if case == "unaligned":
        assert (130, [0]) in _norm(want)[4096]
    if case == "half_full_closes" and group == 16:
        assert [len(m) for _, m in _norm(want)[1024]] == [8, 1]
        assert [len(m) for _, m in _norm(want)[256]] == [8]
    for cap, groups in got.items():
        for s in range(0, len(groups), 3):
            layout = eng._routed_layout(groups[s : s + 3], start, end)
            for g, w in zip(layout, _layout_of(want[cap][s : s + 3], start, end, group)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("route_group", [1, 16])
def test_native_groups_match_jax_on_the_tiny_database_fallback(route_group):
    """A database too small for a sound bin depth (uncertified, so no bin
    depth is forced) routes every query over the cat view (the
    full-coverage cap, type-2 ranges widened to the whole view): the groups
    the engine packs equal the JAX engine's, and the search is exact."""
    ds = generate_dataset(1500, seed=60, categories=12)
    qs = generate_queries(48, seed=61, categories=12)
    jeng, eng = _pair(ds, db_tile=128, query_batch=16, route_group=route_group,
                      certified=False)
    assert eng._route_all_fallback and jeng.bin_top is None
    view_id, start, end = eng.index.query_ranges(qs.qtype, qs.v, qs.l, qs.r)
    full, windows, routed, start, end, _ = eng._plan(qs, view_id, start, end)
    assert full.size == 0 and not windows and [v for v, _ in routed] == [0]
    q_idx = routed[0][1]
    assert q_idx.size == qs.m
    got = eng._pack_groups(start, end, q_idx)
    want = jeng._pack_groups(start, end, q_idx)
    assert _norm(got) == _norm(want) and eng.route_buckets[-1] in got
    for cap, groups in got.items():
        layout = eng._routed_layout(groups, start, end)
        for g, w in zip(layout, _layout_of(want[cap], start, end, route_group)):
            np.testing.assert_array_equal(g, w)
    _exact(ds, qs, eng)


@pytest.mark.parametrize("sample_proportion", [1.0, 0.6])
def test_routed_dispatch_matches_jax_search_routed(routed_pair, sample_proportion):
    ds, qs, jeng, eng = routed_pair
    view_id, start, end = eng.index.query_ranges(qs.qtype, qs.v, qs.l, qs.r)
    q_idx = np.nonzero((view_id == 0) & (end - start <= 2048))[0]
    by_cap = eng._pack_groups(start, end, q_idx)
    cap = max(by_cap, key=lambda c: len(by_cap[c]))
    chunk = by_cap[cap][:8]
    n, k = ds.n, 100
    sn = int(sample_proportion * n)
    jv = jeng.index.cat_view
    out, jslots = jeng._routed_dispatch(
        chunk, cap, qs, start, end,
        (jv.Vp, jv.scan_V, jv.C, jv.T, jv.d_norms, jv.oid, jeng.tail_V),
        (jnp.int32(sn), jnp.int32(n)), k)
    jids, _ = unbundle_ids(np.asarray(out[0]), k, jeng._id_mode)
    jd = np.asarray(out[1])
    g_start, st, en, slots = eng._routed_layout(chunk, start, end)
    Qpack = eng._pack_queries(qs)
    ids, sus, d = eng._search_routed(
        eng.index.cat_view, *map(torch.from_numpy, (g_start, st, en)),
        torch.from_numpy(Qpack[slots]), sn, n, k, cap)
    assert not sus.any()
    ok, jok = slots >= 0, jslots >= 0
    assert sorted(slots[ok]) == sorted(jslots[jok])
    order, jorder = np.argsort(slots[ok]), np.argsort(jslots[jok])
    q = slots[ok][order]
    sub = QuerySet(qtype=qs.qtype[q], v=qs.v[q], l=qs.l[q], r=qs.r[q], V=qs.V[q])
    got_i, got_d = ids.numpy()[ok][order], d.numpy()[ok][order]
    want_i, want_d = jids[jok][jorder], jd[jok][jorder]
    assert_results_match(ds, sub, got_i, got_d, want_i, want_d)
    np.testing.assert_allclose(got_d, want_d, rtol=RTOL_FP32)
    oids, odists = search_oracle(ds, sub, sample_proportion=sample_proportion)
    assert recall_at_k(got_i.astype(np.uint32), oids, got_d, odists) == 1.0


@pytest.fixture(scope="module")
def window_pair():
    ds = generate_dataset(131072, seed=90, categories=10)
    jeng, eng = _pair(ds, db_tile=2048, query_batch=128, time_view_min_queries=1)
    return ds, jeng, eng


@pytest.mark.parametrize("row0_tiles,ntw", [(32, 16), (48, 16), (8, 32)])
def test_full_path_over_a_window_matches_jax(window_pair, row0_tiles, ntw):
    ds, jeng, eng = window_pair
    qs = _type2(128, 92, 0.5, 2.5)
    Dt, n, k, sn = 2048, ds.n, 100, int(0.8 * ds.n)
    row0 = row0_tiles * Dt
    jt = jeng.index.time_view
    a = jeng._query_args(np.arange(qs.m), qs)
    jb, jd = jeng._jit_window(
        jt.Vp, jt.scan_V, jt.C, jt.T, jt.d_norms, jt.oid, jeng.tail_V,
        jnp.int32(row0), *map(jnp.asarray, a), jnp.int32(sn), jnp.int32(n),
        k=k, ntw=ntw)
    jids, jsus = unbundle_ids(np.asarray(jb), k, jeng._id_mode)
    tv = eng.index.time_view
    Q = torch.from_numpy(eng._pack_queries(qs)[: qs.m])
    ids, sus, d = eng._search_full(tv, Q, sn, n, k, row0=row0, ntw=ntw)
    np.testing.assert_array_equal(sus.numpy(), jsus)
    assert_results_match(ds, qs, ids.numpy(), d.numpy(), jids, np.asarray(jd))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=RTOL_FP32)
    # every id comes from the window's rows or the tail pads
    window = set(tv.oid[row0 : row0 + ntw * Dt].tolist())
    pads = set(range(n - k, n))
    assert set(ids.numpy().ravel()) <= window | pads


def _record_jax_routes(jeng):
    """Wrap the JAX engine's dispatch entry points to count its routing."""
    rec = dict(groups={}, routed=0, windows=[], full_batches=0)
    pack, full, full_g = jeng._pack_groups, jeng._jit_full, jeng._jit_full_group
    win, win_g = jeng._jit_window, jeng._jit_window_group

    def pack_groups(start, end, q_idx):
        by_cap = pack(start, end, q_idx)
        for cap, gl in by_cap.items():
            rec["groups"][cap] = rec["groups"].get(cap, 0) + len(gl)
            rec["routed"] += sum(len(m) for _, m in gl)
        return by_cap

    def jit_full(*a, **kw):
        rec["full_batches"] += "bin_top" not in kw     # not a rung-1 run
        return full(*a, **kw)

    def jit_full_group(*a, **kw):
        rec["full_batches"] += a[7].shape[0]
        return full_g(*a, **kw)

    def jit_window(*a, **kw):
        rec["windows"].append((int(a[7]), kw["ntw"]))
        return win(*a, **kw)

    def jit_window_group(*a, **kw):
        rec["windows"] += [(int(r), kw["ntw"]) for r in np.asarray(a[7])]
        return win_g(*a, **kw)

    jeng._pack_groups, jeng._jit_full, jeng._jit_full_group = (
        pack_groups, jit_full, jit_full_group)
    jeng._jit_window, jeng._jit_window_group = jit_window, jit_window_group
    return rec


@pytest.mark.parametrize("workload", ["mixed", "wide_type2"])
def test_engine_on_carried_state_matches_jax_with_the_same_routes(workload):
    ds = generate_dataset(131072, seed=92, categories=30)
    if workload == "mixed":
        qs = _concat(generate_queries(512, seed=93, categories=30),
                     _type2(8, 94, -2, 2, width=0.01))
        buckets = (4096, 32768)
    else:       # caps ≤ 4096 rows (3 % of the view) leave most ranges wide
        qs = _type2(512, 91, 0.5, 2.5)
        buckets = (2048, 4096)
    jeng, eng = _pair(ds, db_tile=2048, query_batch=128, time_view_min_queries=8,
                      route_buckets=buckets)
    rec = _record_jax_routes(jeng)
    jids, jdists = jeng.search(qs)
    ids, dists = _exact(ds, qs, eng)
    assert_results_match(ds, qs, ids, dists, jids, jdists)
    np.testing.assert_allclose(dists, jdists, rtol=RTOL_FP32)
    route = eng.last_route
    assert route["routed_groups"] == rec["groups"]
    assert route["routed_cat"] + route["routed_time"] == rec["routed"]
    assert sorted((r0, w) for r0, w, _ in eng.last_windows) == sorted(rec["windows"])
    assert route["full_batches"] == rec["full_batches"]
    assert route["time_view_built"] == (jeng.index._time_view is not None)
    assert route["full"] + route["windowed"] + rec["routed"] == qs.m
    if workload == "wide_type2":
        assert eng.last_windows and route["routed_cat"] == 0
    else:
        assert route["routed_cat"] and route["routed_time"] and route["full"]


# --- the JAX file's engine cases, against the oracle --------------------------

def _small():
    return (generate_dataset(2000, seed=7, categories=20),
            generate_queries(64, seed=11, categories=20))


def case_oracle_small():
    ds, qs = _small()
    _exact(ds, qs, PartitionedEngine(ds, db_tile=128, query_batch=32, device="cpu"))


def _case_type(t):
    def run():
        ds, _ = _small()
        qs = generate_queries(16, seed=200 + t, categories=20, types=(t,))
        _exact(ds, qs, PartitionedEngine(ds, db_tile=128, query_batch=32, device="cpu"))
    return run


def case_sample_proportion():
    ds, qs = _small()
    _exact(ds, qs, PartitionedEngine(ds, db_tile=128, query_batch=32, device="cpu"), 0.41)


def case_full_scan_route():
    ds = generate_dataset(131072, seed=60, categories=10)
    qs = generate_queries(16, seed=61, categories=10)
    eng = PartitionedEngine(ds, db_tile=2048, query_batch=16, device="cpu")
    assert eng.bin_top is not None
    _exact(ds, qs, eng)
    assert eng.last_route["full"] and eng.last_route["full_batches"]


def case_empty_predicate():
    ds = generate_dataset(600, seed=5, categories=4)
    qs = QuerySet(qtype=np.array([1], np.int32), v=np.array([0.123456], np.float32),
                  l=np.array([-1], np.float32), r=np.array([-1], np.float32),
                  V=np.zeros((1, 100), np.float32))
    ids, _ = _exact(ds, qs, PartitionedEngine(ds, db_tile=128, query_batch=8, device="cpu"))
    assert set(ids[0]) == set(range(500, 600))


def case_bucket_boundaries():
    ds = generate_dataset(20000, seed=70, categories=5)   # ~4000 rows/cat
    eng = PartitionedEngine(ds, db_tile=1024, query_batch=64,
                            route_buckets=(4096, 8192), routed_batch=64, device="cpu")
    qs = generate_queries(48, seed=71, categories=5, types=(1, 3))
    _exact(ds, qs, eng)
    assert len(eng.last_route["routed_groups"]) >= 2


def case_narrow_type2_time_view():
    ds = generate_dataset(30000, seed=72, categories=8)
    qs = _type2(16, 73, -2, 2, width=0.01)                # ~0.2% selectivity
    eng = PartitionedEngine(ds, db_tile=1024, query_batch=16,
                            route_buckets=(2048,), routed_batch=16,
                            time_view_min_queries=1, device="cpu")
    view_id, start, end = eng.index.query_ranges(qs.qtype, qs.v, qs.l, qs.r)
    assert (view_id == 1).all() and ((end - start) <= 2048).all()
    _exact(ds, qs, eng)
    assert eng.index._time_view is not None
    assert eng.last_route["routed_time"] == 16 and eng.last_route["time_view_built"]


def case_time_view_economics_gate():
    ds = generate_dataset(30000, seed=72, categories=8)
    qs = _type2(8, 74, -2, 2, width=0.01)
    eng = PartitionedEngine(ds, db_tile=1024, query_batch=16,
                            route_buckets=(2048,), routed_batch=16, device="cpu")
    _exact(ds, qs, eng)
    assert eng.index._time_view is None                    # no 2nd copy
    assert eng.last_route["routed_time"] == 0 and eng.last_route["full"] == 8
    # the byte budget holds it off too
    eng = PartitionedEngine(ds, index=eng.index, query_batch=16,
                            route_buckets=(2048,), routed_batch=16,
                            time_view_min_queries=1, time_view_max_bytes=1000, device="cpu")
    _exact(ds, qs, eng)
    assert eng.index._time_view is None


def case_time_view_is_lazy():
    ds = generate_dataset(5000, seed=80, categories=10)
    eng = PartitionedEngine(ds, db_tile=512, query_batch=32,
                            route_buckets=(256,), routed_batch=32,
                            time_view_min_queries=1, device="cpu")
    assert eng.index._time_view is None
    _exact(ds, generate_queries(16, seed=81, categories=10, types=(0, 1, 3)), eng)
    assert eng.index._time_view is None
    _exact(ds, _type2(8, 82, -3, -3, width=7.0), eng)      # full-T: always wide
    assert eng.index._time_view is None
    _exact(ds, _type2(1, 83, 0, 0, width=0.001), eng)      # narrow: builds it
    assert eng.index._time_view is not None


def case_windowed_wide_type2():
    ds = generate_dataset(131072, seed=90, categories=10)
    qs = _type2(256, 91, 0.5, 2.5)                         # upper-half starts
    eng = PartitionedEngine(ds, db_tile=2048, query_batch=128,
                            time_view_min_queries=1, device="cpu")
    assert eng.bin_top is not None
    _exact(ds, qs, eng)
    assert eng.index._time_view is not None
    # with caps ≤ 4096 rows most of these ranges are wide: windows run
    eng = PartitionedEngine(ds, index=eng.index, query_batch=128,
                            route_buckets=(4096,), device="cpu")
    _exact(ds, qs, eng)
    assert sum(eng.last_route["windowed_batches"].values()) >= 1


def case_mixed_workload():
    ds = generate_dataset(131072, seed=92, categories=30)
    qs = generate_queries(512, seed=93, categories=30)
    _exact(ds, qs, PartitionedEngine(ds, db_tile=2048, query_batch=128,
                                     time_view_min_queries=8, device="cpu"))


def case_sample_proportion_on_every_route():
    """sn tests ORIGINAL ids on the full, windowed and both routed paths."""
    ds = generate_dataset(131072, seed=92, categories=30)
    qs = _concat(generate_queries(256, seed=95, categories=30),
                 _type2(256, 96, 0.5, 2.5), _type2(8, 97, -2, 2, width=0.01))
    eng = PartitionedEngine(ds, db_tile=2048, query_batch=128,
                            route_buckets=(4096,), time_view_min_queries=1, device="cpu")
    _exact(ds, qs, eng, 0.41)
    route = eng.last_route
    assert route["full"] and route["windowed"]
    assert route["routed_cat"] and route["routed_time"]


CASES = dict(
    oracle_small=case_oracle_small,
    **{f"type{t}": _case_type(t) for t in range(4)},
    sample_proportion=case_sample_proportion,
    full_scan_route=case_full_scan_route,
    empty_predicate=case_empty_predicate,
    bucket_boundaries=case_bucket_boundaries,
    narrow_type2_time_view=case_narrow_type2_time_view,
    time_view_economics_gate=case_time_view_economics_gate,
    time_view_is_lazy=case_time_view_is_lazy,
    windowed_wide_type2=case_windowed_wide_type2,
    mixed_workload=case_mixed_workload,
    sample_proportion_on_every_route=case_sample_proportion_on_every_route,
)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_oracle(case):
    CASES[case]()


def test_each_window_holds_its_batch_candidates():
    """last_windows records each windowed batch: query_batch wide type-2
    queries in range-start order, every range inside its tile window."""
    ds = generate_dataset(131072, seed=90, categories=10)
    qs = _type2(384, 91, 0.5, 2.5)
    eng = PartitionedEngine(ds, db_tile=2048, query_batch=128,
                            route_buckets=(4096,), time_view_min_queries=1, device="cpu")
    _exact(ds, qs, eng)
    view_id, start, end = eng.index.query_ranges(qs.qtype, qs.v, qs.l, qs.r)
    Dt = eng.index.time_view.db_tile
    assert eng.last_windows
    assert len(eng.last_windows) == sum(eng.last_route["windowed_batches"].values())
    seen = np.concatenate([chunk for _, _, chunk in eng.last_windows])
    assert seen.size == np.unique(seen).size == eng.last_route["windowed"]
    for row0, ntw, chunk in eng.last_windows:
        assert chunk.size == eng.query_batch and (view_id[chunk] == 1).all()
        assert (np.diff(start[chunk]) >= 0).all() and row0 % Dt == 0
        assert (start[chunk] >= row0).all()
        assert (end[chunk] <= row0 + ntw * Dt).all()
        assert ntw in {eng.index.cat_view.num_tiles // d for d in (8, 4, 2)}


def test_full_path_puts_the_queries_with_no_predicate_first():
    """_plan's full indices over shuffled types 0-3: the members are the
    queries neither routed nor windowed, those with no predicate first and
    each part in its own order (a stable partition), so that K1's 64-query
    blocks of them run its predicate-free epilogue; the answers stay
    within the oracle's contract."""
    ds = generate_dataset(131072, seed=92, categories=30)
    qs = _concat(generate_queries(512, seed=93, categories=30),
                 _type2(256, 96, 0.5, 2.5))
    eng = PartitionedEngine(ds, db_tile=2048, query_batch=128, route_buckets=(4096,),
                            time_view_min_queries=8, device="cpu")
    view_id, start, end = eng.index.query_ranges(qs.qtype, qs.v, qs.l, qs.r)
    full, windows, routed, *_ = eng._plan(qs, view_id, start, end)
    elsewhere = np.concatenate([c for _, _, c in windows] + [q for _, q in routed])
    assert windows and routed
    np.testing.assert_array_equal(np.sort(full), np.setdiff1d(np.arange(qs.m), elsewhere))
    open_ = qs.qtype[full] == 0
    n_open = int(open_.sum())
    assert 0 < n_open < full.size and open_[:n_open].all()
    assert (np.diff(full[:n_open]) > 0).all() and (np.diff(full[n_open:]) > 0).all()
    assert not (np.diff(full) > 0).all()           # the types were interleaved
    _exact(ds, qs, eng)
    assert eng.last_route["full"] == full.size


def test_forced_ladder_escalates_and_holds_the_sample_limit(monkeypatch):
    """bin_top=1 saturates bins, so the certificate flags; rung 1 (the
    engine's own scan at R=2) and rung 2 (the streaming scan on original
    ids) restore the exact answer at sample_proportion 0.41. Every scan
    call is one full batch, one window or one rung-1 run."""
    ds = generate_dataset(65536, seed=21, categories=20)
    qs = _concat(generate_queries(96, seed=22, categories=20),
                 _type2(64, 23, 1.0, 2.5))
    eng = PartitionedEngine(ds, db_tile=2048, query_batch=32, bin_top=1,
                            route_buckets=(2048,), time_view_min_queries=1, device="cpu")
    calls = []
    orig = kernels.packed_scan_v3
    monkeypatch.setattr(kernels, "packed_scan_v3",
                        lambda *a, **k: calls.append(k["bin_top"]) or orig(*a, **k))
    _exact(ds, qs, eng, 0.41)
    lad, route = eng.last_ladder, eng.last_route
    assert route["ladder"] is lad
    assert lad["suspects"] >= 1 and lad["rung1_runs"] >= 1
    assert lad["rung1_bin_top"] == 2
    assert lad["rung2_queries"] >= 1 and lad["rung2_runs"] >= 1
    batches = route["full_batches"] + sum(route["windowed_batches"].values())
    assert calls == [1] * batches + [2] * lad["rung1_runs"]
    assert route["windowed_batches"]


def test_unported_options_raise(monkeypatch):
    """The options once unported now build; an unknown scan raises."""
    ds = generate_dataset(600, seed=5, categories=4)
    assert PartitionedEngine(ds, repair_bins=1, device="cpu").repair_bins == 1
    bf = PartitionedEngine(ds, dtype=torch.bfloat16, device="cpu")
    assert not bf.certified and bf.index.cat_view.Vp.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        PartitionedEngine(ds, scan_impl="pallas", device="cpu")
    monkeypatch.setenv("HVQ_CERT_TERMS", "1")
    eng = PartitionedEngine(ds, device="cpu")
    assert eng._cert_debug and eng._last_cert_terms is None


@pytest.mark.parametrize("scan_impl,scan_store", [("auto", "fp32"),
                                                  ("auto", "bf16"),
                                                  ("xla_packed", "fp32")])
def test_defaults_follow_the_jax_engine(scan_impl, scan_store):
    ds = generate_dataset(40000, seed=36, categories=30)
    eng = PartitionedEngine(ds, scan_impl=scan_impl, scan_store=scan_store, device="cpu")
    v3 = scan_impl == "auto"
    assert eng.scan_impl == ("v3" if v3 else "packed")
    assert eng.index.cat_view.db_tile == (16384 if v3 else 8192)
    assert eng.kprime == (240 if scan_store == "bf16" else 128)
    assert (eng.query_batch, eng.route_group, eng.routed_batch) == (1024, 16, 4096)
    assert (eng.l2_min_w, eng.time_view_min_queries) == (16384, 4096)
    assert eng.time_view_max_bytes == 4_000_000_000 and eng.certified
    _exact(ds, generate_queries(24, seed=37, categories=30), eng)


def test_return_dists_false_and_phases():
    from hvq_tpu_torch.utils.timing import PhaseTimer

    ds, qs = _small()
    eng = PartitionedEngine(ds, db_tile=128, query_batch=32, device="cpu")
    ids, dists = eng.search(qs)
    timer = PhaseTimer()
    ids2, none = eng.search(qs, return_dists=False, phases=timer)
    assert none is None
    np.testing.assert_array_equal(ids, ids2)
    assert {"search/route", "search/fetch", "search/routed"} <= set(timer.as_dict())


def test_registry_and_cli_run_round_trip(tmp_path):
    from hvq_tpu_torch.cli.main import main

    assert get_engine("partitioned") is PartitionedEngine
    ds = generate_dataset(3000, seed=40, categories=20)
    qs = generate_queries(20, seed=41, categories=20)
    formats.write_data_bin(tmp_path / "data.bin", ds)
    formats.write_query_bin(tmp_path / "queries.bin", qs)
    out = str(tmp_path / "output.bin")
    rc = main(["run", "--data", str(tmp_path / "data.bin"),
               "--queries", str(tmp_path / "queries.bin"),
               "--engine", "partitioned", "--output", out, "--device", "cpu",
               "--query-batch", "8", "--db-tile", "512", "--scan-store", "bf16"])
    assert rc == 0
    ids = formats.read_knn(out)
    dist = formats.read_dist(out + ".dist")
    oids, odists = search_oracle(ds, qs)
    assert_results_match(ds, qs, ids, dist, oids, odists)
    assert recall_at_k(ids, oids, dist, odists) == 1.0
