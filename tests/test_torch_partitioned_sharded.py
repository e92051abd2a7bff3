"""The port's sharded partitioned engine
(``hvq_tpu_torch.models.partitioned_sharded``) against the oracle, the
port's single-device partitioned engine and the JAX
``ShardedPartitionedEngine`` on the same data, both on 8 CPU shards (the
JAX one on conftest's 8 virtual XLA devices): the cases of
``tests/test_partitioned_sharded.py``.

Tolerances: recomputed distances within 0.002 and recall 1.0; the routing
masks equal; the merged ids of a batch unique.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from hvq_tpu.models.oracle import search_oracle
from hvq_tpu.models.partitioned_sharded import ShardedPartitionedEngine as JEngine
from hvq_tpu.utils.compare import recall_at_k
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch.index.partition import PartitionedIndex, build_view
from hvq_tpu_torch.models.partitioned import PartitionedEngine
from hvq_tpu_torch.models.partitioned_sharded import (
    MeshView,
    ShardedPartitionedEngine,
    _slab,
)
from hvq_tpu_torch.parallel.mesh import deal_rows, dealt_window, make_mesh
from hvq_tpu_torch.utils.formats import QuerySet

from conftest import assert_results_match

CPU8 = ["cpu"] * 8


def _exact(ds, qs, ids, dists, oids, odists):
    assert_results_match(ds, qs, ids, dists, oids, odists)
    assert recall_at_k(ids, oids, dists, odists) == 1.0


@pytest.fixture(scope="module")
def engines(small_ds):
    return (JEngine(small_ds, db_tile=128, query_batch=32),
            ShardedPartitionedEngine(small_ds, mesh=make_mesh(devices=CPU8), db_tile=128,
                                     query_batch=32))


def test_matches_oracle_and_jax(small_ds, small_qs, oracle_small, engines):
    jeng, eng = engines
    assert eng._local_n == jeng._local_n == 256 and eng.n_d == 8
    ids, dists = eng.search(small_qs)
    _exact(small_ds, small_qs, ids, dists, *oracle_small)
    _exact(small_ds, small_qs, ids, dists, *jeng.search(small_qs))


def test_matches_the_single_device_port_engine(small_ds, small_qs, engines):
    single = PartitionedEngine(small_ds, device="cpu", db_tile=128, query_batch=32)
    ids, dists = engines[1].search(small_qs)
    _exact(small_ds, small_qs, ids, dists, *single.search(small_qs))


@pytest.mark.parametrize("qtype", [0, 1, 2, 3])
def test_all_types(small_ds, engines, qtype):
    qs = generate_queries(16, seed=300 + qtype, categories=20, types=(qtype,))
    ids, dists = engines[1].search(qs)
    _exact(small_ds, qs, ids, dists, *search_oracle(small_ds, qs))
    _exact(small_ds, qs, ids, dists, *engines[0].search(qs))


def test_sample_proportion(small_ds, small_qs, engines):
    """sn applies to ORIGINAL file order across the slabs (each slab's oid
    column is its sample ids)."""
    ids, dists = engines[1].search(small_qs, sample_proportion=0.37)
    oracle = search_oracle(small_ds, small_qs, sample_proportion=0.37)
    _exact(small_ds, small_qs, ids, dists, *oracle)
    _exact(small_ds, small_qs, ids, dists,
           *engines[0].search(small_qs, sample_proportion=0.37))


def test_routable_extra_matches_jax_and_straddling_spans_go_dense(small_ds, small_qs,
                                                                  engines):
    jeng, eng = engines
    _, start, end = eng.index.query_ranges(small_qs.qtype, small_qs.v, small_qs.l,
                                           small_qs.r)
    extra = eng._routable_extra(start, end)
    np.testing.assert_array_equal(extra, jeng._routable_extra(start, end))
    ln = eng._local_n
    np.testing.assert_array_equal(extra, (start // ln) == (np.maximum(end - 1, start) // ln))
    assert not extra.all()


def test_full_scan_packed_route_with_homed_routed_groups():
    """131072 rows: a sound per-shard bin depth (K1's plain version on each
    slab, the merge), routed groups homed to their shards, straddling
    spans sent dense, against the oracle and the JAX engine."""
    ds = generate_dataset(131072, seed=70, categories=10)
    qs = generate_queries(32, seed=71, categories=10)
    jeng = JEngine(ds, db_tile=2048, query_batch=32)
    eng = ShardedPartitionedEngine(ds, mesh=make_mesh(devices=CPU8), db_tile=2048,
                                   query_batch=32)
    assert eng.bin_top is not None and eng.bin_top == jeng.bin_top
    assert eng.route_buckets == jeng.route_buckets
    ids, dists = eng.search(qs)
    _exact(ds, qs, ids, dists, *search_oracle(ds, qs))
    _exact(ds, qs, ids, dists, *jeng.search(qs))
    route = eng.last_route
    assert route["full_batches"] >= 1 and route["routed_cat"] >= 1
    assert route["dense_straddling"] >= 1 and route["windowed"] == 0
    assert route["routed_dispatches"] >= 2


def test_merged_ids_are_unique_and_original(small_ds, engines):
    """A dense batch of type-0 queries fills all k slots with real rows:
    every id in a row is distinct, and each is an original id."""
    eng = engines[1]
    qs = generate_queries(32, seed=9, categories=20, types=(0,))
    Q = torch.from_numpy(eng._pack_queries(qs)[:32])
    ids, sus, d = eng._search_full(eng._get_view(0), Q, small_ds.n, small_ds.n, 100)
    ids = ids.numpy()
    assert ids.dtype == np.int32
    assert all(np.unique(row).size == row.size for row in ids)
    want = ((small_ds.V[ids.astype(np.int64)] - qs.V[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d.numpy(), want, rtol=1e-5, atol=1e-3)


def test_windows_run_on_the_mesh_and_q_axis_rejected(small_ds):
    """Windows run on the mesh: the time view is dealt tile by tile, the
    wide type-2 batches take windows, narrow type-2 spans are not routed
    on the dealt view; a mesh with a q axis is rejected."""
    qs = generate_queries(64, seed=12, categories=20, types=(2,))
    eng = ShardedPartitionedEngine(small_ds, mesh=make_mesh(devices=CPU8), db_tile=128,
                                   query_batch=32, route_buckets=(128,),
                                   time_view_min_queries=1)
    ids, dists = eng.search(qs)
    _exact(small_ds, qs, ids, dists, *search_oracle(small_ds, qs))
    route = eng.last_route
    assert route["windowed"] >= 32 and eng.last_windows
    assert sum(route["windowed_batches"].values()) == len(eng.last_windows)
    assert route["routed_time"] == 0 and route["time_unrouted"] >= 1
    assert route["time_view_built"] and eng.index.time_view.dealt
    assert eng.index.time_view.n_pad == eng.index.cat_view.n_pad == 2048
    with pytest.raises(ValueError, match="'d' axis"):
        ShardedPartitionedEngine(small_ds, mesh=make_mesh(4, 2, devices=CPU8))


# --- the views placed card by card, the time view dealt, windows on ---------

CPU4 = ["cpu"] * 4


DT = 512        # a tile: 8 a shard, 32 in a view


@pytest.fixture(scope="module")
def wide():
    """16384 rows on 4 shards of 4096 rows (8 tiles each; the last tile
    part padding): a sound per-shard bin depth, so wide type-2 batches
    take windows."""
    ds = generate_dataset(16384 - 300, seed=80, categories=40)
    eng = ShardedPartitionedEngine(ds, mesh=make_mesh(devices=CPU4), db_tile=DT,
                                   query_batch=32, time_view_min_queries=1)
    return ds, eng


def _mixed_queries(seed):
    """32 queries of types 0, 1 and 3, 128 type-2 queries with the
    contest's l ~ U[-3, 3], r ~ U[l, 4], and 16 narrow type-2 spans."""
    rng = np.random.default_rng(seed)
    parts = [generate_queries(32, seed=seed + t, categories=40, types=(t,))
             for t in (0, 1, 3)]
    parts.append(generate_queries(128, seed=seed + 2, categories=40, types=(2,)))
    l = rng.uniform(-3, 2.9, 16).astype(np.float32)
    parts.append(QuerySet(qtype=np.full(16, 2, np.int32), v=np.full(16, -1.0, np.float32),
                          l=l, r=l + np.float32(0.05),
                          V=rng.uniform(-6, 6, (16, 100)).astype(np.float32)))
    return QuerySet(**{f: np.concatenate([getattr(q, f) for q in parts])
                       for f in ("qtype", "v", "l", "r", "V")})


def _judge(ds, qs, ids, sample_proportion):
    """The benchmark's check (``hvq_bench.checks.exact_knn``) of the ids
    against its plain reference (``hvq_bench.reference.search``)."""
    from hvq_bench.checks import exact_knn

    cfg = dict(k=100, sample_proportion=sample_proportion,
               guarantees=dict(dist_tolerance=0.002))
    db = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (ds.C, ds.T, ds.V))
    q = {f: torch.from_numpy(np.ascontiguousarray(getattr(qs, f)))
         for f in ("qtype", "v", "l", "r", "V")}
    return exact_knn.judge(cfg, db, q, torch.from_numpy(ids.astype(np.int64)))


@pytest.mark.parametrize("sample_proportion", [1.0, 0.6])
def test_all_types_with_the_time_view_dealt_and_windows_on(wide, sample_proportion):
    """Every query type on 4 shards, the time view dealt and wide type-2
    batches windowed: exact against the benchmark's plain reference and
    the oracle, no bad or duplicate ids, narrow type-2 spans unrouted."""
    ds, eng = wide
    qs = _mixed_queries(90)
    ids, dists = eng.search(qs, sample_proportion=sample_proportion)
    res = _judge(ds, qs, ids, sample_proportion)
    assert res["dist_gap"] <= 0.002 and res["bad_ids"] == 0 and res["dup_ids"] == 0, res
    assert res["failed"] == 0, res
    _exact(ds, qs, ids, dists, *search_oracle(ds, qs, sample_proportion=sample_proportion))
    route = eng.last_route
    assert sum(route["windowed_batches"].values()) >= 1 and route["windowed"] >= 32
    assert route["routed_time"] == 0 and route["time_unrouted"] >= 1
    assert route["routed_cat"] >= 1 and route["full_batches"] >= 1
    assert eng.index._time_view is not None


@pytest.mark.parametrize("route_group,routed_groups", [(1, 16), (16, 2)])
def test_per_slab_groups_and_dispatches_match_jax(wide, monkeypatch, route_group,
                                                   routed_groups):
    """On 4 virtual shards: the routed queries of types 1 and 3 are packed
    slab by slab into the JAX engine's groups (its ``_pack_groups`` on each
    slab's queries), and every dispatch carries, in the shards' round-robin
    order, ``routed_groups`` of one slab's groups in that slab's own
    positions, a pad place with an empty span; the answers stay exact."""
    from hvq_tpu.models.partitioned import PartitionedEngine as JPartitioned

    ds, eng = wide
    monkeypatch.setattr(eng, "route_group", route_group)
    monkeypatch.setattr(eng, "routed_groups", routed_groups)
    qs = generate_queries(96, seed=95, categories=40, types=(1, 3))
    view_id, start, end = eng.index.query_ranges(qs.qtype, qs.v, qs.l, qs.r)
    _, _, routed, start, end, _ = eng._plan(qs, view_id, start, end)
    (vid, q_idx), = routed
    assert vid == 0
    ln, G = eng._local_n, route_group
    host = types.SimpleNamespace(route_buckets=eng.route_buckets, route_group=G)
    slab_of = start[q_idx] // ln
    want = {}                                     # {cap: {shard: [(g_start, members)]}}
    for sh in np.unique(slab_of).tolist():
        got = eng._pack_groups(start, end, q_idx[slab_of == sh])
        jax = JPartitioned._pack_groups(host, start, end, q_idx[slab_of == sh])
        norm = lambda d: {c: [(int(g), [int(q) for q in m]) for g, m in v] for c, v in d.items()}
        assert norm(got) == norm(jax)
        for cap, groups in jax.items():
            want.setdefault(cap, {})[sh] = groups
    assert len(np.unique(slab_of)) >= 2
    expected = []
    for cap in sorted(want):
        for s in range(0, max(map(len, want[cap].values())), routed_groups):
            for sh in sorted(want[cap]):
                chunk = want[cap][sh][s : s + routed_groups]
                if not chunk:
                    continue
                off = sh * ln
                st = np.zeros((len(chunk), G), np.int64)
                en = np.zeros_like(st)
                slots = np.full(len(chunk) * G, -1, np.int64)
                for gi, (_, members) in enumerate(chunk):
                    for qi, q in enumerate(members):
                        st[gi, qi], en[gi, qi] = start[q] - off, end[q] - off
                        slots[gi * G + qi] = q
                expected.append((sh, cap, np.array([g - off for g, _ in chunk]), st, en,
                                 slots))
    seen = []
    search_routed = eng._search_routed

    def record(view, g_start, st, en, Q, sn, n, k, cap):
        shard = next(j for j, v in enumerate(eng.index.cat_view.shards) if v is view)
        seen.append((shard, cap, g_start.numpy(), st.numpy(), en.numpy()))
        return search_routed(view, g_start, st, en, Q, sn, n, k, cap)

    monkeypatch.setattr(eng, "_search_routed", record)
    ids, dists = eng.search(qs)
    assert eng.last_route["routed_dispatches"] == len(seen) == len(expected) >= 3
    for (sh, cap, g, st, en), want_ in zip(seen, expected):
        assert (sh, cap) == want_[:2]
        for a, b in zip((g, st, en), want_[2:5]):
            np.testing.assert_array_equal(a, b)
    _exact(ds, qs, ids, dists, *search_oracle(ds, qs))


def test_each_shard_holds_its_rows_and_no_whole_view_exists(wide):
    """Each shard's device tensors hold n_pad / n_d rows: the cat view's
    contiguous slab j, equal to the same rows of the one-device view; the
    MeshView itself holds host keys and the shards, no device tensor."""
    ds, eng = wide
    eng.index.time_view
    whole = PartitionedIndex.build(ds, db_tile=DT, device="cpu", row_multiple=4 * DT)
    for mv in (eng.index.cat_view, eng.index.time_view):
        assert not any(isinstance(getattr(mv, f.name), torch.Tensor)
                       for f in dataclasses.fields(mv))
        assert mv.n_pad == whole.cat_view.n_pad and mv.n == ds.n
        L = mv.n_pad // eng.n_d
        for v in mv.shards:
            for t in (v.Vp, v.scan_V, v.C, v.T, v.d_norms, v.oid):
                assert t.shape[0] == L
    cv, ref = eng.index.cat_view, whole.cat_view
    for j, v in enumerate(cv.shards):
        rows = slice(j * eng._local_n, (j + 1) * eng._local_n)
        for f in ("Vp", "C", "T", "d_norms", "oid"):
            assert torch.equal(getattr(v, f), getattr(ref, f)[rows]), (j, f)
    np.testing.assert_array_equal(cv.C_key, ref.C_key)
    assert cv.dn_max == ref.dn_max and cv.nbytes == ref.nbytes
    assert cv.device_nbytes == ref.nbytes      # four shards of one device


def test_the_time_view_is_dealt_tile_by_tile(wide):
    """Shard j holds the whole time view's tiles j, j + 4, …, in order."""
    ds, eng = wide
    tv = eng.index.time_view
    perm = np.argsort(ds.T, kind="stable")
    ref = build_view(ds, perm, DT, torch.device("cpu"), n_pad=tv.n_pad)
    Dt, nd = tv.db_tile, eng.n_d
    for j, v in enumerate(tv.shards):
        tiles = np.arange(j, tv.num_tiles, nd)
        rows = torch.from_numpy((tiles[:, None] * Dt + np.arange(Dt)).reshape(-1))
        for f in ("Vp", "C", "T", "d_norms", "oid"):
            assert torch.equal(getattr(v, f), getattr(ref, f)[rows]), (j, f)


def test_the_ladders_stream_scores_many_tiles_at_once(wide):
    """The rung-2 stream scores each shard's tiles many at a time: the
    same distances as the tile-by-tile stream, and exact against the
    oracle."""
    ds, eng = wide
    qs = _mixed_queries(93)
    sel = np.r_[0:6, 32:38, 96:102, 200:206]
    sub = QuerySet(**{f: getattr(qs, f)[sel] for f in ("qtype", "v", "l", "r", "V")})
    Q = torch.from_numpy(eng._pack_queries(sub)[:-1])
    mv = eng._get_view(0)
    ids, sus, d = eng._search_stream(mv, Q, ds.n, ds.n, 100)
    slabs = [_slab(v) for v in mv.shards]
    _, _, d_tiles = eng._sharded_scan(slabs, mv.db_tile, Q, ds.n, ds.n, 100, None, False,
                                      "stream")
    assert not sus.any()
    np.testing.assert_allclose(d.numpy(), d_tiles.numpy(), rtol=0, atol=0)
    _exact(ds, sub, ids.numpy().astype(np.uint32), d.numpy(), *search_oracle(ds, sub))


@pytest.mark.parametrize("tile0,ntiles", [(0, 4), (3, 5), (16, 16), (17, 15), (28, 4),
                                          (31, 1), (12, 8)])
def test_a_window_is_one_local_range_on_every_shard(tile0, ntiles):
    """A window of whole tiles of a view dealt over 4 shards of 8 tiles is
    one contiguous range of local tiles on every shard, of one width,
    holding all of that shard's tiles of the window."""
    nd, local = 4, 8
    owned = deal_rows(nd * local, nd, tile=1)       # a row a tile: positions = tiles
    w, starts = dealt_window(tile0, ntiles, nd, local)
    assert w == -(-ntiles // nd)
    want = set(range(tile0, tile0 + ntiles))
    got = set()
    for j in range(nd):
        assert 0 <= starts[j] <= local - w
        mine = owned[j][starts[j] : starts[j] + w]
        assert set(owned[j]) & want <= set(mine)
        got |= set(mine) & want
    assert got == want


@pytest.mark.parametrize("budget,built", [("share", True), ("below", False)])
def test_the_time_view_budget_is_one_cards_share(budget, built, monkeypatch):
    """``time_view_max_bytes`` is set against what one card holds of the
    view: between one card's share and the whole view, the view is built
    on a mesh of four cards; below the share it is not. Here the four CPU
    shards share one device, so each is counted as a card of its own."""
    monkeypatch.setattr(MeshView, "device_nbytes",
                        property(lambda self: self.nbytes // len(self.shards)))
    ds = generate_dataset(16384 - 300, seed=81, categories=40)
    qs = generate_queries(96, seed=82, categories=40, types=(2,))
    kw = dict(mesh=make_mesh(devices=CPU4), db_tile=DT, query_batch=32)
    whole = ShardedPartitionedEngine(ds, **kw).index.cat_view.nbytes
    share = whole // 4
    eng = ShardedPartitionedEngine(
        ds, **kw, time_view_min_queries=1,
        time_view_max_bytes=(share + whole) // 2 if budget == "share" else share - 1)
    ids, dists = eng.search(qs)
    _exact(ds, qs, ids, dists, *search_oracle(ds, qs))
    assert (eng.index._time_view is not None) == built
    assert bool(eng.last_route["windowed"]) == built


def test_a_views_card_bytes_count_each_device_once():
    """``MeshView.device_nbytes``: the most bytes one device holds, each
    device's shards summed."""
    def shards(devices):
        return [types.SimpleNamespace(device=torch.device(d), nbytes=100) for d in devices]

    mv = MeshView(shards(["cuda:0", "cuda:1", "cuda:2", "cuda:3"]), None, None, 1, 4, 1,
                  False, 0.0)
    assert mv.nbytes == 400 and mv.device_nbytes == 100
    mv.shards = shards(["cuda:0", "cuda:0", "cuda:1", "cuda:0"])
    assert mv.nbytes == 400 and mv.device_nbytes == 300


def test_cli_runs_both_mesh_engines_on_the_cpu(tmp_path, small_ds, small_qs):
    """``run --engine sharded|partitioned_sharded --device cpu`` (one CPU
    shard, the default mesh of that device), then ``compare``."""
    from hvq_tpu_torch.cli.main import main
    from hvq_tpu_torch.utils import formats

    data, query = str(tmp_path / "d.bin"), str(tmp_path / "q.bin")
    formats.write_data_bin(data, small_ds)
    formats.write_query_bin(query, small_qs)
    outs = []
    for engine in ("oracle", "sharded", "partitioned_sharded"):
        out = str(tmp_path / f"{engine}.bin")
        assert main(["run", "--data", data, "--queries", query, "--engine", engine,
                     "--device", "cpu", "--db-tile", "512", "--output", out]) == 0
        outs.append(out)
    assert main(["compare", *outs]) == 0
