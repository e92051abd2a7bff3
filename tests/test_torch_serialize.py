"""Index checkpoints across the two packages: the same ``.npz`` keys and
format version, so a checkpoint either package writes loads in the other
and answers the same (recomputed distances within 0.002; the exact
partitioned engine also with recall@100 = 1.0 against the oracle)."""

import numpy as np
import pytest
import torch

from hvq_tpu.index import serialize as jser
from hvq_tpu.index.ivf import IVFIndex as JaxIVFIndex
from hvq_tpu.index.partition import PartitionedIndex as JaxPartitionedIndex
from hvq_tpu.models.ivf import IVFEngine as JaxIVFEngine
from hvq_tpu.models.oracle import search_oracle
from hvq_tpu.models.partitioned import PartitionedEngine as JaxPartitionedEngine
from hvq_tpu.utils.compare import recall_at_k
from hvq_tpu.utils.formats import recompute_result_distances
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch.index import serialize
from hvq_tpu_torch.index.ivf import IVFIndex
from hvq_tpu_torch.index.partition import PartitionedIndex
from hvq_tpu_torch.models.ivf import IVFEngine
from hvq_tpu_torch.models.partitioned import PartitionedEngine

TOL = 0.002
VIEW = ("Vp", "C", "T", "d_norms", "oid")


@pytest.fixture(scope="module")
def clustered():
    ds = generate_dataset(4000, seed=6, categories=8, clusters=16)
    qs = generate_queries(16, seed=7, categories=8, clusters=16, centers_seed=6)
    return ds, qs


def _same_answers(ds, qs, a, b):
    (ids_a, d_a), (ids_b, d_b) = a, b
    ra = recompute_result_distances(ds, qs, ids_a.astype(np.int64))
    rb = recompute_result_distances(ds, qs, ids_b.astype(np.int64))
    np.testing.assert_allclose(ra, rb, atol=TOL, rtol=0)
    np.testing.assert_allclose(d_a, d_b, atol=TOL, rtol=0)


def test_jax_partitioned_checkpoint_loads_in_the_port(tmp_path, small_ds, small_qs):
    jidx = JaxPartitionedIndex.build(small_ds, db_tile=128)
    p = tmp_path / "part.npz"
    jser.save_partitioned(jidx, p)
    idx = serialize.load_index(p, device="cpu")
    assert isinstance(idx, PartitionedIndex) and idx._time_view is not None
    for name, jv, tv in (("cat", jidx.cat_view, idx.cat_view),
                         ("time", jidx.time_view, idx.time_view)):
        for f in VIEW:
            np.testing.assert_array_equal(getattr(tv, f).numpy(), np.asarray(getattr(jv, f)))
        assert (tv.n, tv.db_tile) == (jv.n, jv.db_tile), name
    np.testing.assert_array_equal(idx.T_sorted, np.asarray(jidx.T_sorted))
    kw = dict(query_batch=32)
    ids, d = PartitionedEngine(small_ds, index=idx, device="cpu", **kw).search(small_qs)
    jres = JaxPartitionedEngine(small_ds, db_tile=128, index=jidx, **kw).search(small_qs)
    _same_answers(small_ds, small_qs, (ids, d), jres)
    oids, odists = search_oracle(small_ds, small_qs)
    assert recall_at_k(ids, oids, d, odists) == 1.0


def test_port_partitioned_checkpoint_loads_in_jax(tmp_path, small_ds, small_qs):
    idx = PartitionedIndex.build(small_ds, db_tile=128, device="cpu")
    assert idx._time_view is None
    p = tmp_path / "part.npz"
    serialize.save_partitioned(idx, p)          # builds the lazy time view
    assert idx._time_view is not None
    jidx = jser.load_index(p)
    assert isinstance(jidx, JaxPartitionedIndex)
    for f in VIEW:
        np.testing.assert_array_equal(np.asarray(getattr(jidx.time_view, f)),
                                      getattr(idx.time_view, f).numpy())
    kw = dict(query_batch=32)
    jres = JaxPartitionedEngine(small_ds, db_tile=128, index=jidx, **kw).search(small_qs)
    ids, d = PartitionedEngine(small_ds, index=idx, device="cpu", **kw).search(small_qs)
    _same_answers(small_ds, small_qs, (ids, d), jres)
    reload = serialize.load_index(p, device="cpu")
    for f in VIEW:
        assert torch.equal(getattr(reload.cat_view, f), getattr(idx.cat_view, f))


def test_jax_ivf_checkpoint_loads_in_the_port(tmp_path, clustered):
    ds, qs = clustered
    jidx = JaxIVFIndex.build(ds, cap=128, iters=3)
    p = tmp_path / "ivf.npz"
    jser.save_ivf(jidx, p)
    idx = serialize.load_index(p, device="cpu")
    assert isinstance(idx, IVFIndex)
    for f in ("Vp", "C", "T", "oid", "d_norms", "centroids", "c_norms"):
        np.testing.assert_array_equal(getattr(idx, f).numpy(), np.asarray(getattr(jidx, f)))
    for f in ("cat_vals", "cat_freq", "t_sample"):
        np.testing.assert_array_equal(getattr(idx, f), getattr(jidx, f))
    assert (idx.n, idx.cap, idx.scan_tile) == (jidx.n, jidx.cap, jidx.scan_tile)
    res = IVFEngine(ds, index=idx, query_batch=16, device="cpu").search(qs)
    _same_answers(ds, qs, res, JaxIVFEngine(ds, query_batch=16, index=jidx).search(qs))


def test_port_ivf_checkpoint_loads_in_jax(tmp_path, clustered):
    ds, qs = clustered
    idx = IVFIndex.build(ds, cap=128, iters=3, device="cpu")
    p = tmp_path / "ivf.npz"
    serialize.save_ivf(idx, p)
    jidx = jser.load_index(p)
    assert isinstance(jidx, JaxIVFIndex)
    np.testing.assert_array_equal(np.asarray(jidx.oid), idx.oid.numpy())
    np.testing.assert_array_equal(np.asarray(jidx.centroids), idx.centroids.numpy())
    res = IVFEngine(ds, index=idx, query_batch=16, device="cpu").search(qs)
    _same_answers(ds, qs, res, JaxIVFEngine(ds, query_batch=16, index=jidx).search(qs))


def test_checkpoint_version_and_kind_are_checked(tmp_path):
    p = tmp_path / "bad.npz"
    np.savez(p, __kind__=np.array("ivf"), __version__=np.array(2))
    with pytest.raises(ValueError, match="version 2"):
        serialize.load_index(p, device="cpu")
    np.savez(p, __kind__=np.array("hnsw"), __version__=np.array(1))
    with pytest.raises(ValueError, match="hnsw"):
        serialize.load_index(p, device="cpu")
