"""The port's device mesh and cross-shard merges (``hvq_tpu_torch.parallel``)
against the JAX package's (``hvq_tpu.parallel``) on conftest's 8 virtual
XLA CPU devices, and the port's entry points (``hvq_tpu_torch.entry``).

Tolerances: mesh shapes and errors equal; the merge's scores bit for bit
and its ids equal wherever a score is distinct in its row (``torch.topk``
and ``lax.top_k`` may keep another of two equal scores); the term minimum
bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from hvq_tpu.parallel.collectives import allgather_topk_merge as jmerge
from hvq_tpu.parallel.mesh import make_mesh as jmake_mesh
from hvq_tpu_torch.parallel import mesh as tmesh
from hvq_tpu_torch.parallel.collectives import allgather_topk_merge, min_terms

try:  # JAX >= 0.6 exports shard_map at top level
    from jax import shard_map
except ImportError:  # pragma: no cover - older JAX
    from jax.experimental.shard_map import shard_map

CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("n_d,n_q", [(None, 1), (4, 2), (3, 3), (None, 3), (2, 4)])
def test_make_mesh_shapes_and_errors_match_jax(n_d, n_q):
    try:
        jm = jmake_mesh(n_db_shards=n_d, n_query_shards=n_q)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.make_mesh(n_db_shards=n_d, n_query_shards=n_q, devices=CPU8)
        assert str(got.value) == str(e)
        return
    tm = tmesh.make_mesh(n_db_shards=n_d, n_query_shards=n_q, devices=CPU8)
    assert tm.devices.shape == jm.devices.shape
    assert tm.shape == dict(jm.shape)
    assert all(d == torch.device("cpu") for d in tm.devices.flat)


def test_default_mesh_is_every_card_and_raises_without_one(monkeypatch, small_ds):
    from hvq_tpu_torch import get_engine

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        tmesh.make_mesh()
    for name in ("sharded", "partitioned_sharded"):
        with pytest.raises(RuntimeError):
            get_engine(name)(small_ds)
        with pytest.raises(RuntimeError):
            get_engine(name)(small_ds, device="cuda")
    # never a CPU fallback: the CPU comes from an explicit device or mesh
    assert tmesh.engine_mesh(None, "cpu").shape == {"q": 1, "d": 1}


def test_engine_mesh_rejects_a_disagreeing_device():
    m = tmesh.make_mesh(devices=CPU8)
    assert tmesh.engine_mesh(m, None) is m and tmesh.engine_mesh(m, "cpu") is m
    with pytest.raises(ValueError, match="disagrees"):
        tmesh.engine_mesh(m, "cuda")
    with pytest.raises(ValueError, match="one type"):
        tmesh.Mesh(np.array([[torch.device("cpu"), torch.device("cuda", 0)]], dtype=object))


@pytest.mark.parametrize("n_q", [1, 2])
@pytest.mark.parametrize("host", [False, True])
def test_slabs_of_one_device_are_views_of_one_allocation(n_q, host):
    m = tmesh.make_mesh(n_query_shards=n_q, devices=CPU8)
    n_d = 8 // n_q
    x = np.arange(64 * 5, dtype=np.float32).reshape(64, 5)
    src = x if host else torch.from_numpy(x.copy())
    grid = tmesh.shard_rows(m, src)
    base = (torch.from_numpy(x) if host else src).untyped_storage().data_ptr()
    L = 64 // n_d
    for i in range(n_q):
        for j in range(n_d):
            slab = grid[i][j]
            assert slab.untyped_storage().data_ptr() == base      # no copy
            assert slab.data_ptr() == base + j * L * 5 * 4        # its own rows
            np.testing.assert_array_equal(slab.numpy(), x[j * L : (j + 1) * L])
    with pytest.raises(ValueError):
        tmesh.shard_rows(m, np.zeros((63, 2)))


def test_replicate_and_split_queries():
    m = tmesh.make_mesh(n_query_shards=2, devices=CPU8)
    tail = np.ones((4, 128), np.float32)
    rep = tmesh.replicate(m, tail)
    assert all(t is rep[0][0] for row in rep for t in row)
    block = np.arange(32 * 104, dtype=np.float32).reshape(32, 104)
    grid = tmesh.split_queries(m, block)
    for i in range(2):
        assert all(q is grid[i][0] for q in grid[i])    # one upload a device
        np.testing.assert_array_equal(grid[i][0].numpy(), block[16 * i : 16 * (i + 1)])
    with pytest.raises(ValueError):
        tmesh.split_queries(m, block[:31])


def _tiles(seed=0, n_d=8, B=16, kp=128):
    """(n_d, B, k') tiles of exact distances with many exact ties across
    and within shards, +inf empty slots (rows 0-3 with fewer than k′
    finite candidates in all, so the merge keeps +inf; whole empty rows on
    shard 3), and unique global ids."""
    rng = np.random.default_rng(seed)
    s = (rng.integers(0, 400, (n_d, B, kp)) / 8).astype(np.float32)
    s[rng.random((n_d, B, kp)) < 0.2] = np.inf
    s[:, :4, 6:] = np.inf
    s[3, 4:8] = np.inf
    ids = (np.arange(n_d)[:, None, None] * 100_000
           + rng.permutation(n_d * B * kp).reshape(n_d, B, kp) % 100_000).astype(np.int32)
    return s, ids


def _jax_shard_map(fn, *arrays):
    jm = jmake_mesh()
    spec = tuple(P("d") for _ in arrays)
    out = shard_map(fn, mesh=jm, in_specs=spec, out_specs=P("d"), check_vma=False)(*arrays)
    return np.asarray(out)


@pytest.mark.parametrize("seed", [0, 1])
def test_allgather_topk_merge_matches_jax_under_shard_map(seed):
    s, ids = _tiles(seed)
    kp = s.shape[2]

    def local(sl, il):
        m_s, m_i = jmerge(sl[0], il[0], kp, axis_name="d")
        return jax.numpy.concatenate([m_s.view(jax.numpy.int32), m_i], axis=1)[None]

    jout = _jax_shard_map(local, s, ids)[0]         # every shard holds the merge
    j_s, j_i = jout[:, :kp].view(np.float32), jout[:, kp:]
    t_s, t_i = allgather_topk_merge([torch.from_numpy(x) for x in s],
                                    [torch.from_numpy(x) for x in ids], kp,
                                    torch.device("cpu"))
    t_s, t_i = t_s.numpy(), t_i.numpy()
    np.testing.assert_array_equal(t_s.view(np.int32), j_s.view(np.int32))
    flat = np.moveaxis(s, 0, 1).reshape(s.shape[1], -1)
    for b in range(s.shape[1]):
        vals, counts = np.unique(flat[b], return_counts=True)
        distinct = np.isin(t_s[b], vals[counts == 1]) & np.isfinite(t_s[b])
        assert distinct.any()
        np.testing.assert_array_equal(t_i[b][distinct], j_i[b][distinct])
    assert np.isinf(t_s).any() and (t_s[:, 1:] >= t_s[:, :-1]).all()


def test_min_terms_matches_pmin():
    rng = np.random.default_rng(5)
    terms = rng.standard_normal((8, 16, 3)).astype(np.float32)
    terms[rng.random(terms.shape) < 0.3] = np.inf
    terms[:, 0, 1] = np.inf                      # a term absent on every shard
    want = _jax_shard_map(lambda t: jax.lax.pmin(t[0], "d")[None], terms)[0]
    got = min_terms([torch.from_numpy(t) for t in terms], torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.isinf(got[0, 1])


def test_entry_step_and_multichip_dry_run_on_cpu_shards(monkeypatch):
    from hvq_tpu_torch import entry

    # the D=10⁶ capacity leg: tests/test_torch_capacity.py, at a CPU size
    monkeypatch.setenv("HVQ_DRYRUN_CAPACITY", "0")
    fn, args = entry.entry("cpu")
    ids, dists = fn(*args)
    assert tuple(ids.shape) == tuple(dists.shape) == (32, 100)
    assert ids.dtype == torch.int32 and bool(torch.isfinite(dists).all())
    out = entry.dryrun_multichip(8, device="cpu")
    assert set(out) == {"sharded", "partitioned_sharded"}
    assert all(v <= 0.002 for v in out.values())
