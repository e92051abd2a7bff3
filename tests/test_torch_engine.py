"""The port's batched engine on the CPU against the oracle and the JAX engine.

The contract is the JAX package's: recomputed result distances within
0.002 of the oracle's (tests/conftest.py:assert_results_match) and
recall@100 = 1.0. Against the JAX ``BatchedEngine(scan_impl="xla_packed")``
both engines search the SAME stored state, carried across with
``DeviceDB.from_arrays``.
"""

import numpy as np
import pytest

from hvq_tpu.models.batched import BatchedEngine as JaxBatchedEngine
from hvq_tpu.models.oracle import search_oracle
from hvq_tpu.utils import formats
from hvq_tpu.utils.compare import recall_at_k
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch import available_engines, get_engine
from hvq_tpu_torch.models import batched as tbatched
from hvq_tpu_torch.models.batched import BatchedEngine
from hvq_tpu_torch.models.device_db import DeviceDB

from conftest import assert_results_match
from test_certificate import _adversarial_pair


def _exact(ds, qs, eng, sample_proportion=1.0):
    oids, odists = search_oracle(ds, qs, sample_proportion=sample_proportion)
    ids, dists = eng.search(qs, sample_proportion=sample_proportion)
    assert ids.dtype == np.uint32 and dists.dtype == np.float32
    assert ids.shape == dists.shape == (qs.m, 100)
    assert_results_match(ds, qs, ids, dists, oids, odists)
    assert recall_at_k(ids, oids, dists, odists) == 1.0
    return ids, dists


@pytest.fixture(scope="module")
def ds_qs():
    return (generate_dataset(20000, seed=30, categories=25),
            generate_queries(40, seed=31, categories=25))


@pytest.mark.parametrize("scan_impl", ["auto", "packed", "stream"])
@pytest.mark.parametrize("scan_store", ["fp32", "bf16"])
def test_engine_matches_oracle(ds_qs, scan_impl, scan_store):
    ds, qs = ds_qs
    eng = BatchedEngine(ds, device="cpu", query_batch=16, scan_impl=scan_impl,
                        scan_store=scan_store)
    assert eng.certified and eng.db.db_tile == 16384
    assert eng.kprime == (240 if scan_store == "bf16" else 128)
    assert eng.scan_impl == ("v3" if scan_impl == "auto" else scan_impl)
    _exact(ds, qs, eng)


@pytest.mark.parametrize("p", [0.5, 0.0])
def test_sample_proportion(ds_qs, p):
    ds, qs = ds_qs
    eng = BatchedEngine(ds, query_batch=16, device="cpu")
    ids, _ = _exact(ds, qs, eng, sample_proportion=p)
    if p == 0.0:       # nothing scanned: every slot is a tail pad
        pads = np.arange(ds.n - 100, ds.n)
        assert (np.sort(ids, axis=1) == pads[None, :]).all()


def test_heavy_pad_path():
    ds = generate_dataset(1500, seed=32, categories=500)
    qs = generate_queries(24, seed=33, categories=500)
    _exact(ds, qs, BatchedEngine(ds, query_batch=8, device="cpu"))


def test_ragged_sizes():
    ds = generate_dataset(777, seed=34, categories=20)
    qs = generate_queries(13, seed=35, categories=20)
    eng = BatchedEngine(ds, db_tile=256, query_batch=8, device="cpu")
    assert eng.db.n_pad == 1024
    _exact(ds, qs, eng)


@pytest.mark.parametrize("scan_store", ["fp32", "bf16"])
def test_bin_concentration_flags_and_ladder_restores(scan_store):
    """tests/test_certificate.py's adversarial layout at the port's tile:
    32 near-copies of query 0 share one axis1 bin, more than R (and 2R) can
    keep. The certificate must flag, the ladder must escalate to the
    streaming rung, and the result must stay exact."""
    ds, qs, hot = _adversarial_pair(db_tile=16384)
    eng = BatchedEngine(ds, query_batch=8, scan_store=scan_store, device="cpu")
    assert 2 * eng.bin_top < hot.size
    ids, _ = _exact(ds, qs, eng)
    lad = eng.last_ladder
    assert lad["suspects"] >= 1 and lad["rung1_runs"] >= 1
    assert lad["rung1_bin_top"] == 2 * eng.bin_top
    assert lad["rung2_queries"] >= 1 and lad["rung2_runs"] >= 1
    assert set(hot[:16].tolist()) <= set(ids[0][:32].tolist())


def test_uncertified_scan_loses_the_concentrated_bin():
    """The layout is genuinely adversarial: without the certificate the
    packed scan at the same R drops part of the hot bin."""
    ds, qs, _ = _adversarial_pair(db_tile=16384)
    R = BatchedEngine(ds, query_batch=8, device="cpu").bin_top
    eng = BatchedEngine(ds, query_batch=8, certified=False, bin_top=R, device="cpu")
    oids, odists = search_oracle(ds, qs)
    ids, dists = eng.search(qs)
    assert recall_at_k(ids[:1], oids[:1], dists[:1], odists[:1]) < 1.0


def test_deeper_rung_suffices_on_a_random_layout(monkeypatch):
    """bin_top forced to 3 on a random layout saturates bins, so the
    certificate fires; the 2R rung must already be exact (the streaming
    rung stays idle), and each rung-1 run is one more packed scan."""
    ds = generate_dataset(65536, seed=21, categories=20)
    qs = generate_queries(32, seed=22, categories=20)
    eng = BatchedEngine(ds, db_tile=8192, query_batch=32, bin_top=3,
                        scan_impl="packed", device="cpu")
    calls = []
    orig = tbatched.packed_scan_plain
    monkeypatch.setattr(tbatched, "packed_scan_plain",
                        lambda *a, **k: calls.append(k["bin_top"]) or orig(*a, **k))
    _exact(ds, qs, eng)
    lad = eng.last_ladder
    assert lad["suspects"] >= 1 and lad["rung2_queries"] == 0
    assert calls == [3] + [6] * lad["rung1_runs"]


def test_level2_reduce_runs_and_stays_exact(monkeypatch):
    ds = generate_dataset(65536, seed=13, categories=20)
    qs = generate_queries(32, seed=14, categories=20)
    # W = nt·R·bins = 128·32·4 = 16384: just at the level-2 gate
    eng = BatchedEngine(ds, db_tile=512, query_batch=32, bin_top=32, device="cpu")
    calls = []
    orig = tbatched.binned_stream_topk
    monkeypatch.setattr(tbatched, "binned_stream_topk",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    _exact(ds, qs, eng)
    assert calls


@pytest.mark.parametrize("scan_store", ["fp32", "bf16"])
def test_matches_jax_engine_on_the_same_stored_state(scan_store):
    ds = generate_dataset(40000, seed=36, categories=30)
    qs = generate_queries(32, seed=37, categories=30)
    jeng = JaxBatchedEngine(ds, db_tile=16384, query_batch=16,
                            scan_impl="xla_packed", scan_store=scan_store)
    jdb = jeng.db
    db = DeviceDB.from_arrays(
        np.asarray(jdb.Vp), np.asarray(jdb.C), np.asarray(jdb.T),
        np.asarray(jdb.d_norms), jdb.n, jdb.db_tile,
        V_scan=None if jdb.V_scan is None else np.asarray(jdb.V_scan), device="cpu",
    )
    eng = BatchedEngine(ds, query_batch=16, device_db=db, device="cpu")
    assert (eng.bin_top, eng.kprime, eng.certified) == (
        jeng.bin_top, jeng.kprime, jeng.certified)
    ids, dists = eng.search(qs)
    jids, jdists = jeng.search(qs)
    # same contract against each other as against the oracle, and the
    # refined fp32 distances agree to fp32 summation order
    assert_results_match(ds, qs, ids, dists, jids, jdists)
    np.testing.assert_allclose(dists, jdists, rtol=128 * 2.0 ** -24)
    assert recall_at_k(ids, jids, dists, jdists) == 1.0


def test_from_arrays_rejects_a_scan_plane_bf16_cannot_hold():
    V = np.random.default_rng(0).standard_normal((256, 128)).astype(np.float32)
    z = np.zeros(256, np.float32)
    with pytest.raises(ValueError):
        DeviceDB.from_arrays(V, z, z, z, 200, 256, V_scan=V, device="cpu")


def test_registry():
    assert available_engines() == ["batched", "ivf", "oracle", "paged", "partitioned",
                                   "partitioned_sharded", "sharded"]
    assert get_engine("batched") is BatchedEngine
    with pytest.raises(KeyError):
        get_engine("no_such_engine")
    ds = generate_dataset(500, seed=38, categories=10)
    qs = generate_queries(4, seed=39, categories=10)
    ids, _ = get_engine("oracle")(ds, device="cpu").search(qs)
    assert ids.shape == (4, 100)


def test_cli_run_round_trip(tmp_path):
    from hvq_tpu_torch.cli.main import main

    ds = generate_dataset(3000, seed=40, categories=20)
    qs = generate_queries(20, seed=41, categories=20)
    formats.write_data_bin(tmp_path / "data.bin", ds)
    formats.write_query_bin(tmp_path / "queries.bin", qs)
    out = str(tmp_path / "output.bin")
    rc = main(["run", "--data", str(tmp_path / "data.bin"),
               "--queries", str(tmp_path / "queries.bin"),
               "--engine", "batched", "--output", out, "--device", "cpu",
               "--query-batch", "8"])
    assert rc == 0
    ids = formats.read_knn(out)
    dist = formats.read_dist(out + ".dist")
    oids, odists = search_oracle(ds, qs)
    assert_results_match(ds, qs, ids, dist, oids, odists)
    assert recall_at_k(ids, oids, dist, odists) == 1.0
