"""The engine options once unported, against the JAX package on the same
numpy inputs: the top-k strategies (``"sort"``, ``"binned"``,
``bin_reduce_min``), the streaming scan's ``strategy`` and
``compute_dtype``, the unpacked deferred bin scan (``scan_impl=
"xla_deferred"``), the packed scan's ``masked=False`` and the bf16
primary storage (``dtype=bfloat16``).

Tolerances: top-k selections equal where the scores are finite and
distinct (ties may keep another id); the deferred scan's columns equal in
their ids where the distances agree, the distances within rtol 1e-5 and
atol 2e-3 (fp32 summation order of the product, and the ‖q‖² shift); the
packed scan as ``tests/test_torch_scan.py`` holds it; the engines under
the 0.002 recomputed-distance contract and recall 1.0, except the
uncertified bf16 storage: recall with a 50.0 distance tolerance ≥ 0.95 and
a relative distance error < 0.05 (``tests/test_engines.py:150-172``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hvq_tpu
from hvq_tpu.models import common as jcommon
from hvq_tpu.models.device_db import DeviceDB as JDeviceDB
from hvq_tpu.models.oracle import search_oracle
from hvq_tpu.ops import pallas_scan as jscan
from hvq_tpu.ops import topk as jtopk
from hvq_tpu.utils.compare import recall_at_k
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch import get_engine
from hvq_tpu_torch.models import common
from hvq_tpu_torch.models.device_db import DeviceDB
from hvq_tpu_torch.ops import scan as tscan
from hvq_tpu_torch.ops import topk as ttopk
from hvq_tpu_torch.parallel.mesh import make_mesh

from conftest import assert_results_match

CPU8 = ["cpu"] * 8
SCAN_TOL = dict(rtol=1e-5, atol=2e-3)


def _stream(seed, B, W, inf_frac=0.2):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0, 100, (B, W)).astype(np.float32)
    s[rng.random((B, W)) < inf_frac] = np.inf
    return s, rng.integers(0, 1 << 20, (B, W)).astype(np.int32)


def _same_where_finite(gs, gi, ws, wi):
    np.testing.assert_array_equal(gs, ws)
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(gi[fin], wi[fin])


@pytest.mark.parametrize("strategy", ["topk", "sort", "binned"])
@pytest.mark.parametrize("kprime", [1, 32, 100])
def test_merge_topk_strategies_match_jax(strategy, kprime):
    cs, ci = _stream(10, 6, kprime)
    ts, ti = _stream(11, 6, 1024)
    ts += 0.125                                   # no ties with the carry
    cs.sort(axis=1)
    got = ttopk.merge_topk(*(torch.from_numpy(x) for x in (cs, ci, ts, ti)), kprime,
                           strategy)
    want = jtopk.merge_topk(*(jnp.asarray(x) for x in (cs, ci, ts, ti)), kprime,
                            strategy)
    _same_where_finite(got[0].numpy(), got[1].numpy(), np.asarray(want[0]),
                       np.asarray(want[1]))
    with pytest.raises(ValueError):
        ttopk.merge_topk(*(torch.from_numpy(x) for x in (cs, ci, ts, ti)), kprime,
                         "approx")


def test_bin_reduce_min_matches_jax_and_keeps_the_first_tie():
    s, i = _stream(12, 4, 1024, inf_frac=0.5)
    s[0, 128:256] = np.inf                        # an empty bin: its lane 0
    s[1, 260] = s[1, 300] = -1.0                  # a tie: the lower column
    got = ttopk.bin_reduce_min(torch.from_numpy(s), torch.from_numpy(i))
    want = jtopk.bin_reduce_min(jnp.asarray(s), jnp.asarray(i))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1][1, 2] == i[1, 260] and got[1][0, 1] == i[0, 128]
    with pytest.raises(ValueError):
        ttopk.bin_reduce_min(torch.zeros(2, 100), torch.zeros(2, 100, dtype=torch.int32))


def _db_case(seed, n_pad=4096, B=8):
    rng = np.random.default_rng(seed)
    Vp = rng.standard_normal((n_pad, 128)).astype(np.float32)
    x = dict(Vp=Vp, C=rng.integers(0, 4, n_pad).astype(np.float32),
             T=rng.uniform(-3, 3, n_pad).astype(np.float32),
             dn=(Vp * Vp).sum(1).astype(np.float32),
             oid=rng.permutation(n_pad).astype(np.int32),
             qV=rng.standard_normal((B, 128)).astype(np.float32),
             ac=rng.random(B) < 0.5, v=rng.integers(0, 4, B).astype(np.float32),
             at=rng.random(B) < 0.5, l=rng.uniform(-3, 0, B).astype(np.float32),
             r=rng.uniform(0, 3, B).astype(np.float32))
    return x


@pytest.mark.parametrize("strategy", ["topk", "sort", "binned"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_database_strategy_and_dtype_match_jax(strategy, dtype):
    """The streaming scan over reordered rows (``oid``) with each merge and
    compute dtype: the same k′ candidates (bf16: the products of the
    rounded values in both)."""
    x = _db_case(20)
    Dt, kp, n_pad = 512, 64, x["Vp"].shape[0]
    nt = n_pad // Dt
    sn = 3000
    jqb = jcommon.QueryBatch(*(jnp.asarray(x[f]) for f in ("qV", "ac", "v", "at", "l", "r")))
    tqb = common.QueryBatch(*(torch.from_numpy(x[f]) for f in ("qV", "ac", "v", "at", "l", "r")))
    js, ji = jcommon.scan_database(
        (jnp.asarray(x["Vp"]).reshape(nt, Dt, 128), jnp.asarray(x["C"]).reshape(nt, Dt),
         jnp.asarray(x["T"]).reshape(nt, Dt), jnp.asarray(x["dn"]).reshape(nt, Dt)),
        jqb, jnp.int32(sn), kp, Dt, precision=jax_highest(), strategy=strategy,
        compute_dtype=getattr(jnp, dtype), oid_tiles=jnp.asarray(x["oid"]).reshape(nt, Dt))
    ts, ti = common.scan_database(
        *(torch.from_numpy(x[f]) for f in ("Vp", "C", "T", "dn")), tqb, sn, kp, Dt,
        precision="highest", oid=torch.from_numpy(x["oid"]), strategy=strategy,
        compute_dtype=getattr(torch, dtype))
    js, ji, ts, ti = np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy()
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=1e-5, atol=1e-3)
    for b in range(js.shape[0]):
        assert set(ti[b][fin[b]].tolist()) == set(ji[b][fin[b]].tolist())


def jax_highest():
    import jax

    return jax.lax.Precision.HIGHEST


def _scan_args(x, lib):
    order = ("Vp", "C", "T", "dn", "oid", "qV", "ac", "v", "at", "l", "r")
    if lib == "jax":
        return [jnp.asarray(x[k]) for k in order]
    return [torch.from_numpy(x[k]) for k in order]


@pytest.mark.parametrize("R", [1, 2, 3])
@pytest.mark.parametrize("payload", [False, True])
def test_deferred_bin_scan_matches_jax(R, payload):
    """Equal columns (tile-major, then round, then bin), the full squared
    distance clamped at 0, the sample limit on the permuted ``oid``, and
    the reported payload (view positions when given)."""
    x = _db_case(21)
    # an unfiltered query that duplicates a row in the sample: its
    # distance ≈ 0, never negative (the clamp)
    x["qV"][0] = x["Vp"][np.argmin(x["oid"])]
    x["ac"][0] = x["at"][0] = False
    sn = 3500
    pay = np.arange(x["Vp"].shape[0], dtype=np.int32) + 7 if payload else None
    want = jscan.deferred_bin_scan_xla(
        *_scan_args(x, "jax"), jnp.int32(sn), db_tile=512, bin_top=R,
        precision=jax_highest(), payload=None if pay is None else jnp.asarray(pay))
    got = tscan.deferred_bin_scan(
        *_scan_args(x, "torch"), sn, db_tile=512, bin_top=R, precision="highest",
        payload=None if pay is None else torch.from_numpy(pay))
    ws, wi = (np.asarray(a) for a in want)
    gs, gi = (a.numpy() for a in got)
    assert gs.shape == ws.shape == (8, 8 * R * 4) and gi.dtype == np.int32
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], **SCAN_TOL)
    # equal ids but for near ties, whose two rows lie within the tolerance
    inv = np.argsort(x["oid"])
    row_of = lambda ids: ids - 7 if payload else inv[ids]
    true = lambda ids: ((x["Vp"][row_of(ids)].astype(np.float64)
                         - x["qV"][:, None, :].astype(np.float64)) ** 2).sum(-1)
    tg, tw = true(gi), true(wi)
    differ = fin & (gi != wi)
    assert differ.mean() < 0.01
    np.testing.assert_allclose(tg[differ], tw[differ], **SCAN_TOL)
    np.testing.assert_allclose(tg[fin], gs[fin], **SCAN_TOL)
    assert (gs[fin] >= 0).all() and gs[0].min() < 1e-2
    # the certificate's per-bin decode reads it as it reads the packed scans
    np.testing.assert_allclose(
        tscan.last_round_dists(got[0], 8, R, 4).numpy(),
        np.asarray(jscan.last_round_dists(want[0], 8, R, 4)), **SCAN_TOL)


@pytest.mark.parametrize("layout", ["axis1", "lane"])
def test_packed_scan_unmasked_matches_jax(layout):
    """``masked=False``: no predicate, no sample limit; padding rows keep
    their distance."""
    x = _db_case(22)
    want = jscan.deferred_packed_scan_xla(
        *_scan_args(x, "jax"), jnp.int32(10), db_tile=1024, bin_top=2,
        precision=jax_highest(), layout=layout, masked=False)
    got = tscan.packed_scan_plain(*_scan_args(x, "torch"), 10, db_tile=1024,
                                  bin_top=2, layout=layout, precision="highest",
                                  masked=False)
    ws, wi = (np.asarray(a) for a in want)
    gs, gi = (a.numpy() for a in got)
    assert np.isfinite(gs).all() and np.isfinite(ws).all()
    np.testing.assert_allclose(gs, ws, rtol=3e-6 + 2.0 ** -16, atol=2e-3)
    same = gs == ws
    np.testing.assert_array_equal(gi[same], wi[same])
    masked = tscan.packed_scan_plain(*_scan_args(x, "torch"), 10, db_tile=1024,
                                     bin_top=2, layout=layout, precision="highest")
    assert np.isinf(masked[0].numpy()).mean() > 0.9


# --- bf16 primary storage -------------------------------------------------------

def test_bf16_storage_device_db_matches_jax():
    """``dtype=bfloat16``: rows rounded once, ‖d‖² of the STORED rows, as
    the JAX DeviceDB; no bf16 scan plane beside it."""
    ds = generate_dataset(3000, seed=30, categories=10)
    db = DeviceDB.from_dataset(ds, db_tile=1024, device="cpu", dtype=torch.bfloat16)
    jdb = JDeviceDB.from_dataset(ds, db_tile=1024, dtype=jnp.bfloat16)
    assert db.Vp.dtype == torch.bfloat16 and db.V_scan is None
    np.testing.assert_array_equal(db.Vp.float().numpy(),
                                  np.asarray(jdb.Vp.astype(jnp.float32)))
    np.testing.assert_allclose(db.d_norms.numpy(), np.asarray(jdb.d_norms), rtol=1e-6)
    rounded = db.Vp.float().numpy()
    np.testing.assert_allclose(db.d_norms.numpy(), (rounded * rounded).sum(1), rtol=1e-6)
    with pytest.raises(ValueError, match="fp32 primary storage"):
        DeviceDB.from_dataset(ds, db_tile=1024, device="cpu", dtype=torch.bfloat16,
                              scan_store="bf16")
    with pytest.raises(ValueError):
        DeviceDB.from_dataset(ds, db_tile=1024, device="cpu", dtype=torch.float16)


def test_bf16_storage_index_matches_jax_and_checkpoints(tmp_path):
    """The partitioned index with ``dtype=bfloat16``: rounded rows as the
    JAX view's, ‖d‖² from the fp32 rows (as the JAX view computes them);
    a checkpoint keeps the rounded values (as fp32)."""
    from hvq_tpu.index.partition import PartitionedIndex as JIndex
    from hvq_tpu_torch.index.partition import PartitionedIndex
    from hvq_tpu_torch.index.serialize import load_index, save_partitioned

    ds = generate_dataset(3000, seed=31, categories=7)
    idx = PartitionedIndex.build(ds, db_tile=512, device="cpu", dtype=torch.bfloat16)
    jidx = JIndex.build(ds, db_tile=512, dtype=jnp.bfloat16)
    cv, jcv = idx.cat_view, jidx.cat_view
    assert cv.Vp.dtype == torch.bfloat16 and idx.time_view.Vp.dtype == torch.bfloat16
    np.testing.assert_array_equal(cv.Vp.float().numpy(), np.asarray(jcv.Vp.astype(jnp.float32)))
    np.testing.assert_allclose(cv.d_norms.numpy(), np.asarray(jcv.d_norms), rtol=1e-6)
    save_partitioned(idx, tmp_path / "p.npz")
    back = load_index(tmp_path / "p.npz", device="cpu")
    assert torch.equal(back.cat_view.Vp, cv.Vp.float())
    with pytest.raises(ValueError, match="fp32 primary storage"):
        PartitionedIndex.build(ds, db_tile=512, device="cpu", dtype=torch.bfloat16,
                               scan_store="bf16")


@pytest.fixture(scope="module")
def bf16_data():
    ds = generate_dataset(32768, seed=80, categories=20)
    qs = generate_queries(32, seed=81, categories=20)
    return ds, qs, search_oracle(ds, qs)


def _bf16_checks(ds, qs, ids, dists, oids, odists):
    assert recall_at_k(ids, oids, dists, odists, tolerance=50.0) >= 0.95
    true_d = ((ds.V[ids.astype(np.int64)] - qs.V[:, None, :]) ** 2).sum(-1)
    assert (np.abs(dists - true_d) / np.maximum(true_d, 1.0)).max() < 0.05


@pytest.mark.parametrize("name,impl", [("batched", "xla_packed"), ("batched", "v3"),
                                       ("batched", "xla"), ("partitioned", "xla_packed"),
                                       ("sharded", "xla_packed")])
def test_bf16_storage_engines_match_jax(bf16_data, name, impl):
    """``tests/test_engines.py::test_bf16_fast_mode_recall`` for the port's
    engines with the JAX batched engine's keywords (``precision=
    "default"``, 512-row tiles): uncertified, recall and distance error
    at the fast mode's own tolerance, beside the JAX engine's answer."""
    ds, qs, (oids, odists) = bf16_data
    kw = dict(db_tile=512, query_batch=32, dtype=torch.bfloat16, precision="default",
              scan_impl=impl)
    if name == "sharded":
        kw["mesh"] = make_mesh(devices=CPU8)
    else:
        kw["device"] = "cpu"
    eng = get_engine(name)(ds, **kw)
    assert not eng.certified
    ids, dists = eng.search(qs)
    _bf16_checks(ds, qs, ids, dists, oids, odists)
    jeng = hvq_tpu.get_engine("batched")(
        ds, db_tile=512, query_batch=32, dtype=jnp.bfloat16, precision="default",
        scan_impl="xla_packed")
    jids, jdists = jeng.search(qs)
    _bf16_checks(ds, qs, jids, jdists, oids, odists)
    assert recall_at_k(ids, jids, dists, jdists, tolerance=50.0) >= 0.95


# --- xla_deferred in the engines --------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    ds = generate_dataset(40000, seed=60, categories=25)
    qs = generate_queries(48, seed=61, categories=25)
    return ds, qs, search_oracle(ds, qs)


@pytest.mark.parametrize("layout", ["axis1", "lane"])
def test_xla_deferred_batched_matches_jax(mixed, layout):
    """The batched engine with ``scan_impl="xla_deferred"`` (lane bins,
    8192-row tiles, R from ``choose_bin_top``, the certificate and its
    ladder) against the JAX engine with the same keywords."""
    ds, qs, (oids, odists) = mixed
    kw = dict(query_batch=16, scan_impl="xla_deferred", scan_layout=layout)
    eng = get_engine("batched")(ds, device="cpu", **kw)
    jeng = hvq_tpu.get_engine("batched")(ds, **kw)
    assert eng.scan_impl == "deferred" and eng.certified
    assert (eng.db.db_tile, eng.bin_top) == (jeng.db.db_tile, jeng.bin_top)
    ids, dists = eng.search(qs)
    jids, jdists = jeng.search(qs)
    assert_results_match(ds, qs, ids, dists, oids, odists)
    assert_results_match(ds, qs, ids, dists, jids, jdists)
    assert recall_at_k(ids, oids, dists, odists) == 1.0


def test_xla_deferred_sharded_matches_jax(mixed):
    """``sharded`` on 8 CPU shards with the deferred scan per shard (its
    payload the slab's own positions), against the JAX engine."""
    ds, qs, (oids, odists) = mixed
    kw = dict(query_batch=16, scan_impl="xla_deferred", db_tile=1024)
    eng = get_engine("sharded")(ds, mesh=make_mesh(devices=CPU8), **kw)
    jeng = hvq_tpu.get_engine("sharded")(ds, **kw)
    assert eng.scan_impl == "deferred" and eng.bin_top == jeng.bin_top
    ids, dists = eng.search(qs)
    jids, jdists = jeng.search(qs)
    assert_results_match(ds, qs, ids, dists, oids, odists)
    assert_results_match(ds, qs, ids, dists, jids, jdists)
    assert recall_at_k(ids, oids, dists, odists) == 1.0


@pytest.mark.parametrize("strategy", ["sort", "binned"])
def test_streaming_engines_take_the_strategy(mixed, strategy):
    """``topk_strategy`` on the batched and sharded streaming paths against
    the JAX engines with the same keywords: ``"sort"`` exact, ``"binned"``
    losing the same rows in both (the same 128-column groups)."""
    ds, qs, (oids, odists) = mixed
    kw = dict(query_batch=16, scan_impl="xla", topk_strategy=strategy, db_tile=1024)
    for name, port_kw in (("batched", dict(device="cpu")),
                          ("sharded", dict(mesh=make_mesh(devices=CPU8)))):
        eng = get_engine(name)(ds, **kw, **port_kw)
        jeng = hvq_tpu.get_engine(name)(ds, **kw)
        assert eng.scan_impl == "stream"
        ids, dists = eng.search(qs)
        jids, jdists = jeng.search(qs)
        assert_results_match(ds, qs, ids, dists, jids, jdists)
        if strategy == "sort":
            assert_results_match(ds, qs, ids, dists, oids, odists)
            assert recall_at_k(ids, oids, dists, odists) == 1.0
