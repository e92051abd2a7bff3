"""The port's k-means, IVF index and IVF engine on the CPU against the JAX
package's.

k-means sums in another order can flip near-tie assignments, so the
engine is held to the JAX engine on a CARRIED index (``IVFIndex.from_host``
of the JAX index's arrays): both then probe the same buckets and must
return recomputed distances within 0.002 of each other on each route
(flat union, streaming union, exact fallback). k-means itself is held by
its initial rows (identical) and its centroids after two Lloyd steps from
them (within 1e-4). An index the port builds itself keeps the JAX gate,
recall@100 ≥ 0.99 against the oracle on clustered data.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvq_tpu.index.ivf import IVFIndex as JaxIVFIndex
from hvq_tpu.models.ivf import IVFEngine as JaxIVFEngine
from hvq_tpu.models.oracle import search_oracle
from hvq_tpu.ops.kmeans import fit_kmeans as jax_fit_kmeans
from hvq_tpu.utils.compare import recall_at_k
from hvq_tpu.utils.formats import QuerySet, recompute_result_distances
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch import get_engine
from hvq_tpu_torch.index.ivf import IVFIndex
from hvq_tpu_torch.models.ivf import IVFEngine
from hvq_tpu_torch.ops.kmeans import fit_kmeans

TOL = 0.002              # the .dist contract
KMEANS_ATOL = 1e-4       # centroids of two Lloyd steps, sums in another order
FIELDS = ("Vp", "C", "T", "oid", "d_norms", "centroids", "c_norms", "n", "cap",
          "scan_tile", "cat_vals", "cat_freq", "t_sample")


@pytest.fixture(scope="module")
def clustered():
    """Clustered data and in-distribution queries (the regime ANN is for)."""
    ds = generate_dataset(20_000, seed=3, categories=8, clusters=64, cluster_std=1.0)
    qs = generate_queries(64, seed=4, categories=8, clusters=64, centers_seed=3)
    return ds, qs


@pytest.fixture(scope="module")
def carried(clustered):
    """The JAX index and the port's copy of it."""
    ds, _ = clustered
    jidx = JaxIVFIndex.build(ds, cap=256, iters=6, seed=0)
    idx = IVFIndex.from_host(**{f: (np.asarray(getattr(jidx, f))
                                   if not isinstance(getattr(jidx, f), int)
                                   else getattr(jidx, f)) for f in FIELDS},
                             device="cpu")
    return jidx, idx


def _padded(V, n_pad):
    out = np.zeros((n_pad, 128), np.float32)
    out[: V.shape[0], :100] = V
    return out


def test_kmeans_matches_jax_from_the_same_rows(clustered):
    ds, _ = clustered
    n, k = 4096, 16
    Vp = _padded(ds.V[:n], n)
    j0, _ = jax_fit_kmeans(jnp.asarray(Vp), n, k, iters=0, db_tile=1024, seed=5)
    t0, _ = fit_kmeans(torch.from_numpy(Vp), n, k, iters=0, db_tile=1024, seed=5)
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0))     # the same rows
    jc, ja = jax_fit_kmeans(jnp.asarray(Vp), n, k, iters=2, db_tile=1024, seed=5)
    tc, ta = fit_kmeans(torch.from_numpy(Vp), n, k, iters=2, db_tile=1024, seed=5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=KMEANS_ATOL, rtol=0)
    assert ta.dtype == np.int32 and ta.shape == (n,)
    assert (ta == np.asarray(ja)).mean() >= 0.999


def test_kmeans_tiles_and_degenerate_sizes():
    rng = np.random.default_rng(0)
    Vp = _padded(rng.uniform(-6, 6, (10, 100)).astype(np.float32), 16)
    with pytest.raises(ValueError, match="not divisible"):
        fit_kmeans(torch.from_numpy(Vp), 10, 4, db_tile=6)
    c, a = fit_kmeans(torch.from_numpy(Vp), 10, 12, iters=2, db_tile=8)
    assert c.shape == (12, 128) and a.shape == (10,) and a.max() < 12


def test_carried_index_is_the_jax_index(carried):
    jidx, idx = carried
    for f in ("Vp", "C", "T", "oid", "d_norms", "centroids", "c_norms"):
        np.testing.assert_array_equal(getattr(idx, f).numpy(), np.asarray(getattr(jidx, f)))
    assert (idx.n, idx.cap, idx.scan_tile, idx.num_buckets) == (
        jidx.n, jidx.cap, jidx.scan_tile, jidx.num_buckets)
    qs = generate_queries(32, seed=8, categories=8)
    np.testing.assert_array_equal(idx.selectivity(qs.qtype, qs.v, qs.l, qs.r),
                                  jidx.selectivity(qs.qtype, qs.v, qs.l, qs.r))


@pytest.mark.parametrize("route,qtypes,kw", [
    ("flat", (0,), {}),
    ("stream", (0,), dict(flat_budget_bytes=0)),
    # one category of 8 needs 8·nprobe probes, above a quarter of the
    # buckets: the exact masked scan of the view
    ("exact", (1,), {}),
])
def test_engine_matches_jax_on_a_carried_index(clustered, carried, route, qtypes, kw):
    ds, _ = clustered
    jidx, idx = carried
    qs = generate_queries(40, seed=12, categories=8, clusters=64, centers_seed=3,
                          types=qtypes)
    kw = dict(nprobe=8, query_batch=16, **kw)
    jids, jd = JaxIVFEngine(ds, index=jidx, **kw).search(qs)
    eng = IVFEngine(ds, index=idx, device="cpu", **kw)
    ids, d = eng.search(qs)
    assert eng.last_route[route] == 3 and sum(eng.last_route.values()) == 3
    assert ids.dtype == np.uint32 and ids.shape == (40, 100)
    mine = recompute_result_distances(ds, qs, ids.astype(np.int64))
    theirs = recompute_result_distances(ds, qs, jids.astype(np.int64))
    np.testing.assert_allclose(mine, theirs, atol=TOL, rtol=0)
    np.testing.assert_allclose(d, jd, atol=TOL, rtol=0)
    np.testing.assert_allclose(d, mine, atol=TOL, rtol=0)
    assert np.all(np.diff(d, axis=1) >= -1e-6)


def test_recall_gate_on_the_ports_own_index(clustered):
    ds, qs = clustered
    eng = get_engine("ivf")(ds, device="cpu", cap=256, nprobe=8, query_batch=64,
                            kmeans_iters=6, seed=0)
    oids, odists = search_oracle(ds, qs)
    ids, dists = eng.search(qs)
    assert recall_at_k(ids, oids, dists, odists) >= 0.99
    # layout: each bucket holds rows of one cluster, every row exactly once
    oid = eng.index.oid.numpy()
    assert np.array_equal(np.sort(oid[oid < ds.n]), np.arange(ds.n))
    assert eng.index.n_pad % eng.index.scan_tile == 0


def test_filtered_probes_keep_recall(clustered, carried):
    ds, _ = clustered
    _, idx = carried
    qs = generate_queries(48, seed=9, categories=8, clusters=64, centers_seed=3,
                          types=(1, 2, 3))
    eng = IVFEngine(ds, index=idx, device="cpu", nprobe=8, query_batch=48)
    oids, odists = search_oracle(ds, qs)
    ids, dists = eng.search(qs)
    assert recall_at_k(ids, oids, dists, odists) >= 0.99


def test_padding_path_and_sample_proportion(clustered, carried):
    ds, qs = clustered
    _, idx = carried
    eng = IVFEngine(ds, index=idx, device="cpu", nprobe=8, query_batch=64)
    oids, odists = search_oracle(ds, qs, sample_proportion=0.7)
    ids, dists = eng.search(qs, sample_proportion=0.7)
    assert recall_at_k(ids, oids, dists, odists) >= 0.98
    none = QuerySet(qtype=np.array([1], np.int32), v=np.array([0.987654], np.float32),
                    l=np.array([-1], np.float32), r=np.array([-1], np.float32),
                    V=np.zeros((1, 100), np.float32))
    ids, dists = eng.search(none)
    assert set(ids[0]) == set(range(ds.n - 100, ds.n))
    assert np.all(np.diff(dists[0]) >= -1e-6)
