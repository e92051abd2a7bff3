"""The port's sharded engine (``hvq_tpu_torch.models.sharded``) against the
oracle and the JAX ``ShardedEngine`` on the same data, both on 8 CPU
shards (the JAX one on conftest's 8 virtual XLA devices): the cases of
``tests/test_engines.py``'s sharded tests.

Tolerances: recomputed distances within 0.002 and recall 1.0 against the
oracle and against the JAX engine; the axis1 bin term on whole-tile
shards bit for bit against the single-store batched engine's; a 1-shard
mesh's distances bit for bit against the batched engine's.
"""

import inspect

import numpy as np
import pytest
import torch

from hvq_tpu.models.oracle import search_oracle
from hvq_tpu.models.sharded import ShardedEngine as JShardedEngine
from hvq_tpu.parallel.mesh import make_mesh as jmake_mesh
from hvq_tpu.utils.compare import recall_at_k
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch.models.batched import (
    BatchedEngine,
    cert_terms,
    pack_query_block,
    slab_scan,
    unpack_query_block,
)
from hvq_tpu_torch.models.sharded import ShardedEngine
from hvq_tpu_torch.ops import kernels
from hvq_tpu_torch.parallel.collectives import min_terms
from hvq_tpu_torch.parallel.mesh import make_mesh

from conftest import assert_results_match

CPU8 = ["cpu"] * 8


def _exact(ds, qs, ids, dists, oids, odists):
    assert ids.shape == oids.shape
    assert_results_match(ds, qs, ids, dists, oids, odists)
    assert recall_at_k(ids, oids, dists, odists) == 1.0


def _pair_check(ds, qs, jeng, eng, k=100, sample_proportion=1.0):
    """Both engines against the oracle and against each other."""
    oids, odists = search_oracle(ds, qs, k=k, sample_proportion=sample_proportion)
    jids, jdists = jeng.search(qs, k=k, sample_proportion=sample_proportion)
    ids, dists = eng.search(qs, k=k, sample_proportion=sample_proportion)
    _exact(ds, qs, ids, dists, oids, odists)
    _exact(ds, qs, jids, jdists, oids, odists)
    _exact(ds, qs, ids, dists, jids, jdists)
    return eng


@pytest.mark.parametrize("db_tile", [64, 128])
def test_sharded_matches_oracle_and_jax(small_ds, small_qs, db_tile):
    """8 shards, B 32: at db_tile 64 (not whole 128-row bins) both engines
    stream; at 128 the port runs K1's plain version per shard."""
    eng = _pair_check(
        small_ds, small_qs,
        JShardedEngine(small_ds, db_tile=db_tile, query_batch=32, kprime=128),
        ShardedEngine(small_ds, mesh=make_mesh(devices=CPU8), db_tile=db_tile,
                      query_batch=32, kprime=128))
    assert eng.n_d == 8 and eng.local_n * 8 == eng.n_pad
    assert eng.scan_impl == ("stream" if db_tile == 64 else "v3")


@pytest.mark.parametrize("db_tile", [64, 128])
def test_sharded_query_axis(small_ds, small_qs, db_tile):
    """2×4 (q, d) mesh: the query batch sharded too."""
    eng = _pair_check(
        small_ds, small_qs,
        JShardedEngine(small_ds, mesh=jmake_mesh(n_db_shards=4, n_query_shards=2),
                       db_tile=db_tile, query_batch=32, kprime=128),
        ShardedEngine(small_ds, mesh=make_mesh(4, 2, devices=CPU8), db_tile=db_tile,
                      query_batch=32, kprime=128))
    assert (eng.n_q, eng.n_d) == (2, 4)


def test_sharded_sample_proportion(small_ds, small_qs):
    _pair_check(small_ds, small_qs,
                JShardedEngine(small_ds, db_tile=64, query_batch=32),
                ShardedEngine(small_ds, mesh=make_mesh(devices=CPU8), db_tile=128,
                              query_batch=32),
                sample_proportion=0.53)


@pytest.mark.parametrize("db_tile", [32, 128])
def test_sharded_padding_path(db_tile):
    """~3 rows a category: the tail pads. At db_tile 128 the 1200 rows pad
    to 2048 over 8 × 256-row shards: shard 4 holds 176 real rows and shards
    5-7 none, whose scans return all +inf."""
    ds = generate_dataset(1200, seed=21, categories=400)
    qs = generate_queries(8, seed=22, categories=400, types=(1, 3))
    eng = _pair_check(ds, qs, JShardedEngine(ds, db_tile=32, query_batch=8),
                      ShardedEngine(ds, mesh=make_mesh(devices=CPU8), db_tile=db_tile,
                                    query_batch=8))
    if db_tile == 128:
        assert eng.n_pad == 2048 and eng.scan_impl == "v3"
        Q = torch.from_numpy(pack_query_block(qs.V, qs.qtype, qs.v, qs.l, qs.r))
        exact, _, terms = slab_scan(eng, eng.slabs[0][7], unpack_query_block(Q), ds.n,
                                    eng.kprime, "v3", eng.bin_top, eng.db_tile)
        assert bool(torch.isinf(exact).all()) and bool(torch.isinf(terms[:, 0]).all())


@pytest.mark.parametrize("k", [1, 10, 128])
def test_sharded_arbitrary_k(small_ds, small_qs, k):
    _pair_check(small_ds, small_qs,
                JShardedEngine(small_ds, db_tile=64, query_batch=32),
                ShardedEngine(small_ds, mesh=make_mesh(devices=CPU8), db_tile=128,
                              query_batch=32), k=k)


def test_sharded_packed_matches_jax_xla_packed():
    ds = generate_dataset(32768, seed=30, categories=20)
    qs = generate_queries(32, seed=31, categories=20)
    jeng = JShardedEngine(ds, db_tile=512, query_batch=32, scan_impl="xla_packed")
    eng = ShardedEngine(ds, mesh=make_mesh(devices=CPU8), db_tile=512, query_batch=32,
                        scan_impl="xla_packed")
    assert (eng.scan_impl, eng.bin_top) == ("packed", jeng.bin_top)
    _pair_check(ds, qs, jeng, eng)


def test_sharded_k1_matches_jax_pallas_v3_interpret():
    """K1's plain version per shard against the JAX engine's Mosaic kernel
    in interpret mode, both at the same per-shard bin depth."""
    ds = generate_dataset(16384, seed=32, categories=20)
    qs = generate_queries(16, seed=33, categories=20)
    jeng = JShardedEngine(ds, db_tile=1024, query_batch=16, scan_impl="pallas_v3",
                          interpret=True)
    eng = ShardedEngine(ds, mesh=make_mesh(devices=CPU8), db_tile=1024, query_batch=16,
                        scan_impl="pallas_v3")
    assert (jeng.scan_impl, eng.scan_impl) == ("pallas_v3", "v3")
    assert eng.bin_top == jeng.bin_top == 24
    _pair_check(ds, qs, jeng, eng)


def test_sharded_k3_matches_jax_pallas_interpret():
    """K3 per shard (the JAX test's own shape: 262144 rows, db_tile 512,
    B 16), the JAX kernel in interpret mode; kernel_bin_top rounds R to 32
    on both sides."""
    ds = generate_dataset(262144, seed=40, categories=20)
    qs = generate_queries(16, seed=41, categories=20)
    jeng = JShardedEngine(ds, db_tile=512, query_batch=16, scan_impl="pallas")
    eng = ShardedEngine(ds, mesh=make_mesh(devices=CPU8), db_tile=512, query_batch=16,
                        scan_impl="pallas")
    assert (jeng.scan_impl, eng.scan_impl) == ("pallas", "v1")
    assert eng.bin_top == jeng.bin_top == 32
    _pair_check(ds, qs, jeng, eng)


def test_axis1_bin_term_on_whole_tile_shards_equals_the_single_store_term():
    """Shards hold whole tiles, so the minimum over shards of each shard's
    bin term (level2=False) is the single store's term, bit for bit."""
    ds = generate_dataset(20000, seed=50, categories=20)
    qs = generate_queries(32, seed=51, categories=20)
    Dt, R = 1024, 4
    eng = ShardedEngine(ds, mesh=make_mesh(devices=CPU8), db_tile=Dt, query_batch=32,
                        bin_top=R)
    single = BatchedEngine(ds, device="cpu", db_tile=Dt, query_batch=32, bin_top=R)
    assert eng.n_pad == 24576 != single.db.n_pad == 20480
    Q = torch.from_numpy(pack_query_block(qs.V, qs.qtype, qs.v, qs.l, qs.r))
    qb = unpack_query_block(Q)
    sn = ds.n
    terms = [slab_scan(eng, slab, qb, sn, eng.kprime, "v3", R, Dt, level2=False)[2]
             for slab in eng.slabs[0]]
    mesh_term = min_terms(terms, torch.device("cpu"))[:, 0]
    db = single.db
    out_s, _ = kernels.packed_scan_v3(db.scan_V, db.C, db.T, db.d_norms, single._pos,
                                      qb.qV, *qb[1:], sn, db_tile=Dt, bin_top=R)
    want = cert_terms(out_s, db.num_tiles, R, Dt // 128, None, None)[:, 0]
    assert bool(torch.isfinite(want).any()) and bool(torch.isinf(want).any())
    assert torch.equal(mesh_term.view(torch.int32), want.view(torch.int32))


def test_forced_ladder_ends_exact(small_ds, small_qs, oracle_small):
    eng = ShardedEngine(small_ds, mesh=make_mesh(devices=CPU8), db_tile=128,
                        query_batch=32, bin_top=1)
    ids, dists = eng.search(small_qs)
    _exact(small_ds, small_qs, ids, dists, *oracle_small)
    lad = eng.last_ladder
    assert lad["suspects"] >= 1 and lad["rung1_runs"] >= 1
    assert lad["rung1_bin_top"] == 2
    assert lad["rung2_queries"] <= lad["suspects"]
    assert lad["rung2_runs"] == -(-lad["rung2_queries"] // 32)


@pytest.mark.parametrize("scan_impl", ["auto", "xla_packed", "xla"])
def test_one_shard_mesh_gives_the_batched_engines_distances_bit_for_bit(
        small_ds, small_qs, scan_impl):
    eng = ShardedEngine(small_ds, mesh=make_mesh(devices=["cpu"]), db_tile=1024,
                        query_batch=32, scan_impl=scan_impl)
    single = BatchedEngine(small_ds, device="cpu", db_tile=1024, query_batch=32,
                           kprime=128, scan_impl=scan_impl)
    assert (eng.scan_impl, eng.bin_top) == (single.scan_impl, single.bin_top)
    ids, dists = eng.search(small_qs)
    sids, sdists = single.search(small_qs)
    np.testing.assert_array_equal(dists.view(np.int32), sdists.view(np.int32))
    assert eng.last_ladder == single.last_ladder


def test_keywords_cover_jax_and_bad_values_raise(small_ds):
    jparams = inspect.signature(JShardedEngine).parameters
    params = inspect.signature(ShardedEngine).parameters
    assert set(jparams) <= set(params) and params["device"].default is None
    for name in ("query_batch", "kprime", "precision", "topk_strategy", "scan_impl",
                 "dispatch_group", "certified", "bin_top", "l2_min_w", "scan_layout",
                 "repair_bins", "repair_gate"):
        assert params[name].default == jparams[name].default, name
    mesh = make_mesh(devices=CPU8)
    with pytest.raises(ValueError):
        ShardedEngine(small_ds, mesh=mesh, scan_impl="pallas_v2")
    # the keywords once unported now build their options
    assert ShardedEngine(small_ds, mesh=mesh, scan_impl="xla_deferred").scan_impl == "deferred"
    bf = ShardedEngine(small_ds, mesh=mesh, dtype=torch.bfloat16)
    assert not bf.certified and bf.slabs[0][0].Vp.dtype == torch.bfloat16
    assert ShardedEngine(small_ds, mesh=mesh, repair_bins=2).repair_bins == 2
    with pytest.raises(ValueError):
        ShardedEngine(small_ds, mesh=mesh, topk_strategy="approx")
    with pytest.raises(ValueError, match="q axis"):
        ShardedEngine(small_ds, mesh=make_mesh(2, 4, devices=CPU8), query_batch=33)
    with pytest.raises(ValueError, match="disagrees"):
        ShardedEngine(small_ds, mesh=mesh, device="cuda")
    # interpret and dispatch_group are accepted and ignored
    eng = ShardedEngine(small_ds, device="cpu", db_tile=512, interpret=True,
                        dispatch_group=3)
    assert eng.mesh.shape == {"q": 1, "d": 1}
