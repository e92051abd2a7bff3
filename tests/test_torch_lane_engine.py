"""The batched engine's lane-layout paths (``scan_impl="v1"``: K3,
``"v2"``: K2) on the CPU, against the oracle and the JAX engine.

The contract is the JAX package's: recomputed result distances within
0.002 of the oracle's (tests/conftest.py:assert_results_match) and
recall@100 = 1.0. The oracle cases mirror tests/test_pallas.py:62-87 and
:420-433. Against the JAX ``BatchedEngine(scan_impl="pallas" /
"pallas_v2")`` (Pallas kernels in interpret mode) both engines search the
SAME stored state at the 8192-row tile, carried across with
``DeviceDB.from_arrays``.
"""

import numpy as np
import pytest

from hvq_tpu.models.batched import BatchedEngine as JaxBatchedEngine
from hvq_tpu.models.oracle import search_oracle
from hvq_tpu.utils.compare import recall_at_k
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch.models import batched as tbatched
from hvq_tpu_torch.models.batched import BatchedEngine
from hvq_tpu_torch.models.device_db import DeviceDB
from hvq_tpu_torch.ops import kernels

from conftest import assert_results_match

JAX_NAME = {"v1": "pallas", "v2": "pallas_v2"}


def _exact(ds, qs, eng, sample_proportion=1.0):
    oids, odists = search_oracle(ds, qs, sample_proportion=sample_proportion)
    ids, dists = eng.search(qs, sample_proportion=sample_proportion)
    assert ids.dtype == np.uint32 and ids.shape == dists.shape == (qs.m, 100)
    assert_results_match(ds, qs, ids, dists, oids, odists)
    assert recall_at_k(ids, oids, dists, odists) == 1.0
    return ids, dists


@pytest.mark.parametrize("impl", ["v1", "v2"])
def test_lane_engine_matches_oracle(impl):
    ds = generate_dataset(32768, seed=30, categories=20)
    qs = generate_queries(32, seed=33, categories=20)
    eng = BatchedEngine(ds, db_tile=512, query_batch=32, scan_impl=impl, device="cpu")
    # kernel_bin_top rounds 8 up to 32 so R·bins = 32·4 = 128, as the JAX
    jeng = JaxBatchedEngine(ds, db_tile=512, query_batch=32,
                            scan_impl=JAX_NAME[impl])
    assert (eng.scan_impl, eng.scan_layout) == (impl, "axis1")
    assert eng.bin_top == jeng.bin_top == 32
    _exact(ds, qs, eng)


@pytest.mark.parametrize("impl", ["v1", "v2"])
def test_lane_engine_padding_and_sample(impl):
    ds = generate_dataset(32768, seed=31, categories=2000)
    qs = generate_queries(8, seed=32, categories=2000, types=(1, 3))
    eng = BatchedEngine(ds, db_tile=256, query_batch=8, scan_impl=impl, device="cpu")
    assert eng.scan_impl == impl
    _exact(ds, qs, eng, sample_proportion=0.6)


@pytest.mark.parametrize("impl", ["v1", "v2"])
def test_lane_engine_non_divisible_query_batch(impl):
    ds = generate_dataset(2048, seed=96, categories=8)
    qs = generate_queries(384, seed=97, categories=8)
    _exact(ds, qs, BatchedEngine(ds, db_tile=512, query_batch=384,
                                 scan_impl=impl, device="cpu"))


def _carried(jeng):
    jdb = jeng.db
    return DeviceDB.from_arrays(
        np.asarray(jdb.Vp), np.asarray(jdb.C), np.asarray(jdb.T),
        np.asarray(jdb.d_norms), jdb.n, jdb.db_tile,
        V_scan=None if jdb.V_scan is None else np.asarray(jdb.V_scan), device="cpu",
    )


@pytest.mark.parametrize("layout", ["axis1", "lane"])
@pytest.mark.parametrize("impl", ["v1", "v2"])
def test_matches_jax_engine_on_the_same_stored_state(impl, layout):
    ds = generate_dataset(40000, seed=36, categories=30)
    qs = generate_queries(32, seed=37, categories=30)
    jeng = JaxBatchedEngine(ds, query_batch=16, scan_impl=JAX_NAME[impl],
                            scan_layout=layout)
    assert jeng.db.db_tile == 8192
    eng = BatchedEngine(ds, query_batch=16, scan_impl=impl, scan_layout=layout,
                        device_db=_carried(jeng), device="cpu")
    assert eng.db.db_tile == 8192
    assert (eng.bin_top, eng.kprime, eng.certified, eng.scan_layout) == (
        jeng.bin_top, jeng.kprime, jeng.certified, jeng.scan_layout)
    ids, dists = eng.search(qs)
    jids, jdists = jeng.search(qs)
    assert_results_match(ds, qs, ids, dists, jids, jdists)
    np.testing.assert_allclose(dists, jdists, rtol=128 * 2.0 ** -24)
    assert recall_at_k(ids, jids, dists, jdists) == 1.0


@pytest.mark.parametrize("impl", ["v1", "v2"])
def test_bf16_store_still_scans_the_fp32_plane(impl, monkeypatch):
    """K3 and K2 read the fp32 Vp whatever scan_store says; the bf16 plane
    only widens the certificate, as in the JAX engine."""
    ds = generate_dataset(20000, seed=38, categories=25)
    qs = generate_queries(24, seed=39, categories=25)
    eng = BatchedEngine(ds, query_batch=8, scan_impl=impl, scan_store="bf16", device="cpu")
    assert eng.db.V_scan is not None and eng.kprime == 240
    name = "packed_scan" if impl == "v1" else "packed_scan_v2"
    planes = []
    orig = getattr(kernels, name)
    monkeypatch.setattr(kernels, name,
                        lambda Vs, *a, **k: planes.append(Vs.dtype) or orig(Vs, *a, **k))
    _exact(ds, qs, eng)
    assert planes and set(planes) == {eng.db.Vp.dtype}


@pytest.mark.parametrize("layout,rung1", [("axis1", "packed_scan_v3"),
                                          ("lane", "packed_scan_v2")])
@pytest.mark.parametrize("impl", ["v1", "v2"])
def test_rung1_is_the_packed_scan_in_scan_layout_at_2R(monkeypatch, impl,
                                                       layout, rung1):
    """bin_top forced to 2 on a random layout saturates bins, so the
    certificate fires. Each suspect batch re-runs through the packed scan
    in scan_layout at 2R — K1 for axis1, K2 for lane, the JAX engine's
    ``xla_packed`` rung — and the result stays exact."""
    ds = generate_dataset(65536, seed=21, categories=20)
    qs = generate_queries(32, seed=22, categories=20)
    eng = BatchedEngine(ds, query_batch=32, bin_top=2, scan_impl=impl,
                        scan_layout=layout, device="cpu")
    calls = []
    for name in ("packed_scan_v3", "packed_scan", "packed_scan_v2"):
        orig = getattr(kernels, name)
        monkeypatch.setattr(
            kernels, name,
            lambda *a, _n=name, _o=orig, **k: calls.append((_n, k["bin_top"]))
            or _o(*a, **k))
    _exact(ds, qs, eng)
    lad = eng.last_ladder
    assert lad["suspects"] >= 1 and lad["rung1_runs"] >= 1
    assert lad["rung1_bin_top"] == 4
    main = "packed_scan" if impl == "v1" else "packed_scan_v2"
    assert calls == [(main, 2)] + [(rung1, 4)] * lad["rung1_runs"]


def test_lane_level2_reduce_runs_and_stays_exact(monkeypatch):
    """The lane layout's level-2 gate needs nt ≥ 128 tiles as well as
    W ≥ 16384: 128 tiles of 128 rows at R = 128 reach it."""
    ds = generate_dataset(16384, seed=15, categories=20)
    qs = generate_queries(16, seed=16, categories=20)
    eng = BatchedEngine(ds, db_tile=128, query_batch=16, bin_top=128,
                        scan_impl="v2", scan_layout="lane", device="cpu")
    assert eng.db.num_tiles == 128
    calls = []
    orig = tbatched.binned_stream_topk
    monkeypatch.setattr(tbatched, "binned_stream_topk",
                        lambda *a, **k: calls.append(k) or orig(*a, **k))
    _exact(ds, qs, eng)
    assert calls and calls[0]["layout"] == "lane" and calls[0]["nt"] == 128


def test_scan_impl_takes_the_jax_names_and_v3_forces_axis1():
    ds = generate_dataset(3000, seed=40, categories=10)
    for jax_name, port in (("pallas", "v1"), ("pallas_v2", "v2"),
                           ("pallas_v3", "v3"), ("xla_packed", "packed"),
                           ("xla_deferred", "deferred"),
                           ("xla", "stream"), ("auto", "v3")):
        eng = BatchedEngine(ds, query_batch=8, scan_impl=jax_name,
                            scan_layout="lane", device="cpu")
        assert eng.scan_impl == port
        assert eng.scan_layout == ("axis1" if port == "v3" else "lane")
        assert eng.db.db_tile == (8192 if port in ("v1", "v2", "deferred") else 16384)
    for bad in dict(scan_impl="xla_fused"), dict(scan_layout="rows"):
        with pytest.raises(ValueError):
            BatchedEngine(ds, **bad, device="cpu")
