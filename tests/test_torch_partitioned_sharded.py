"""The port's sharded partitioned engine
(``hvq_tpu_torch.models.partitioned_sharded``) against the oracle, the
port's single-device partitioned engine and the JAX
``ShardedPartitionedEngine`` on the same data, both on 8 CPU shards (the
JAX one on conftest's 8 virtual XLA devices): the cases of
``tests/test_partitioned_sharded.py``.

Tolerances: recomputed distances within 0.002 and recall 1.0; the routing
masks equal; the merged ids of a batch unique.
"""

import numpy as np
import pytest
import torch

from hvq_tpu.models.oracle import search_oracle
from hvq_tpu.models.partitioned_sharded import ShardedPartitionedEngine as JEngine
from hvq_tpu.utils.compare import recall_at_k
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch.models.partitioned import PartitionedEngine
from hvq_tpu_torch.models.partitioned_sharded import ShardedPartitionedEngine
from hvq_tpu_torch.parallel.mesh import make_mesh

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


def test_windows_off_and_q_axis_rejected(small_ds):
    qs = generate_queries(64, seed=12, categories=20, types=(2,))
    eng = ShardedPartitionedEngine(small_ds, mesh=make_mesh(devices=CPU8), db_tile=128,
                                   query_batch=32, route_buckets=(128,),
                                   time_view_min_queries=1)
    ids, dists = eng.search(qs)
    _exact(small_ds, qs, ids, dists, *search_oracle(small_ds, qs))
    assert eng.last_route["windowed"] == 0 and eng.last_windows == []
    assert eng.last_route["routed_time"] >= 1 and eng.last_route["time_view_built"]
    assert eng.index.time_view.n_pad == eng.index.cat_view.n_pad == 2048
    with pytest.raises(ValueError, match="'d' axis"):
        ShardedPartitionedEngine(small_ds, mesh=make_mesh(4, 2, devices=CPU8))


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
