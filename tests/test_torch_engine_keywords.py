"""The port's engine constructors take the JAX engines' keywords.

Each port engine's parameters cover the JAX class's (plus ``device``);
``kprime`` and ``precision`` are implemented on the batched engine and
held against the JAX ``BatchedEngine`` with the same keywords on the same
numpy data, under the 0.002 recomputed-distance contract; ``dtype``,
``topk_strategy``, ``repair_bins`` and ``repair_gate`` work at a
non-default value on both engines, each held against the JAX engine with
the same keywords (bf16 storage at its own tolerance: recall with a 50.0
distance tolerance ≥ 0.95 and a relative distance error < 0.05, as
``tests/test_engines.py::test_bf16_fast_mode_recall``); the TPU-relay
keywords are accepted and change nothing.
"""

import inspect

import numpy as np
import pytest

from hvq_tpu.models.batched import BatchedEngine as JaxBatchedEngine
from hvq_tpu.models.oracle import search_oracle
from hvq_tpu.models.partitioned import PartitionedEngine as JaxPartitionedEngine
from hvq_tpu.utils.compare import recall_at_k
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch import get_engine
from hvq_tpu_torch.models.batched import BatchedEngine
from hvq_tpu_torch.models.partitioned import PartitionedEngine

from conftest import assert_results_match

_PAIRS = {"batched": (BatchedEngine, JaxBatchedEngine),
          "partitioned": (PartitionedEngine, JaxPartitionedEngine)}


@pytest.fixture(scope="module")
def ds_qs():
    return (generate_dataset(20000, seed=50, categories=25),
            generate_queries(24, seed=51, categories=25))


@pytest.mark.parametrize("name", sorted(_PAIRS))
def test_constructor_covers_the_jax_parameters(name):
    port, jax_cls = _PAIRS[name]
    mine = inspect.signature(port).parameters
    theirs = inspect.signature(jax_cls).parameters
    assert set(theirs) <= set(mine)
    assert set(mine) - set(theirs) == {"device"}
    # the same defaults, where they are plain values; time_view_max_bytes
    # is sized for the card (None: a quarter of its memory)
    for p in set(theirs) - {"time_view_max_bytes"}:
        d = theirs[p].default
        if isinstance(d, (int, str, bool, tuple)) or d is None:
            assert mine[p].default == d, p


@pytest.mark.parametrize("kw", [dict(kprime=128), dict(kprime=200),
                                dict(precision="highest"),
                                dict(kprime=160, precision="highest")])
def test_batched_keywords_match_the_jax_engine(ds_qs, kw):
    """``get_engine("batched")(ds, **kw, device="cpu")`` (K1's plain
    version) against the JAX engine with the same keywords."""
    ds, qs = ds_qs
    eng = get_engine("batched")(ds, query_batch=8, device="cpu", **kw)
    jeng = JaxBatchedEngine(ds, db_tile=16384, query_batch=8, **kw)
    assert eng.kprime == jeng.kprime == kw.get("kprime", 128)
    assert (eng.bin_top, eng.certified) == (jeng.bin_top, jeng.certified)
    assert eng.tail_V.shape[0] == jeng.tail_V.shape[0] == eng.kprime
    ids, dists = eng.search(qs)
    jids, jdists = jeng.search(qs)
    assert_results_match(ds, qs, ids, dists, jids, jdists)
    oids, odists = search_oracle(ds, qs)
    assert_results_match(ds, qs, ids, dists, oids, odists)
    assert recall_at_k(ids, oids, dists, odists) == 1.0


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("scan_store", ["fp32", "bf16"])
def test_precision_reaches_the_plain_scan_and_the_certificate(ds_qs, precision,
                                                              scan_store):
    """``precision`` sets the plain packed scan's passes (one on the bf16
    plane whatever it says) and turns the certificate off below three
    passes on the fp32 plane, as the JAX engine's (``xla_packed``) does."""
    ds, qs = ds_qs
    kw = dict(query_batch=8, scan_impl="xla_packed", precision=precision,
              scan_store=scan_store)
    eng = BatchedEngine(ds, device="cpu", **kw)
    jeng = JaxBatchedEngine(ds, **kw)
    assert eng.certified == jeng.certified
    assert eng.certified == (scan_store == "bf16" or precision != "default")
    assert eng._scan_precision == ("default" if scan_store == "bf16" else precision)
    ids, dists = eng.search(qs)
    jids, jdists = jeng.search(qs)
    assert_results_match(ds, qs, ids, dists, jids, jdists)


def test_precision_reaches_the_streaming_scan(ds_qs, monkeypatch):
    from hvq_tpu_torch.models import common

    ds, qs = ds_qs
    seen = []
    orig = common.scan_database
    monkeypatch.setattr(common, "scan_database",
                        lambda *a, **k: seen.append(k["precision"]) or orig(*a, **k))
    eng = BatchedEngine(ds, query_batch=8, scan_impl="stream", precision="highest",
                        device="cpu")
    ids, dists = eng.search(qs)
    assert seen and set(seen) == {"highest"}
    oids, odists = search_oracle(ds, qs)
    assert_results_match(ds, qs, ids, dists, oids, odists)


def test_k3_at_one_pass_raises_and_names_the_combination(ds_qs):
    ds, _ = ds_qs
    with pytest.raises(NotImplementedError, match="K3.*default"):
        BatchedEngine(ds, scan_impl="pallas", precision="default", device="cpu")
    with pytest.raises(ValueError):
        BatchedEngine(ds, precision="bf16x9", device="cpu")


@pytest.mark.parametrize("name", sorted(_PAIRS))
@pytest.mark.parametrize("kw", [dict(dtype="bfloat16"), dict(topk_strategy="binned"),
                                dict(repair_bins=2), dict(repair_gate=True)])
def test_unported_keywords_raise_on_a_non_default_value(ds_qs, name, kw):
    """Once unported, now each keyword at a non-default value against the
    JAX engine with the same keywords (``"bfloat16"`` is ``jnp.bfloat16``
    there)."""
    import jax.numpy as jnp

    ds, qs = ds_qs
    port, jax_cls = _PAIRS[name]
    jkw = dict(kw, dtype=jnp.bfloat16) if "dtype" in kw else dict(kw)
    base = dict(query_batch=8)
    if name == "batched":
        base.update(db_tile=16384)
    # the strategy is the streaming scan's: the batched pair streams (the
    # partitioned one streams only on its ladder's last rung)
    binned = "topk_strategy" in kw and name == "batched"
    if binned:
        base.update(scan_impl="xla")
    eng = port(ds, device="cpu", **base, **kw)
    jeng = jax_cls(ds, **base, **jkw)
    ids, dists = eng.search(qs)
    jids, jdists = jeng.search(qs)
    oids, odists = search_oracle(ds, qs)
    if "dtype" in kw:
        assert not eng.certified and not jeng.certified
        true_d = ((ds.V[ids.astype(np.int64)] - qs.V[:, None, :]) ** 2).sum(-1)
        for i, d in ((ids, dists), (jids, jdists)):
            assert recall_at_k(i, oids, d, odists, tolerance=50.0) >= 0.95
        assert (np.abs(dists - true_d) / np.maximum(true_d, 1.0)).max() < 0.05
    elif binned:
        # approximate: the same groups of 128 columns lose the same rows
        assert_results_match(ds, qs, ids, dists, jids, jdists)
        assert recall_at_k(ids, jids, dists, jdists) == 1.0
    else:
        assert_results_match(ds, qs, ids, dists, oids, odists)
        assert_results_match(ds, qs, ids, dists, jids, jdists)
        assert recall_at_k(ids, oids, dists, odists) == 1.0


@pytest.mark.parametrize("name", sorted(_PAIRS))
def test_relay_keywords_are_accepted_and_change_nothing(ds_qs, name):
    ds, qs = ds_qs
    port = _PAIRS[name][0]
    base = dict(query_batch=8, device="cpu")
    if name == "partitioned":
        base["db_tile"] = 2048
    relay = dict(dispatch_group=4)
    if name == "batched":
        relay.update(interpret=True, v3_b_block=128)
    ids, dists = port(ds, **base).search(qs)
    ids2, dists2 = port(ds, **base, **relay, dtype="float32", topk_strategy="topk",
                        repair_bins=0, repair_gate=False).search(qs)
    np.testing.assert_array_equal(dists, dists2)
    assert_results_match(ds, qs, ids, dists, ids2, dists2)


def test_lane_rung1_follows_precision(ds_qs, monkeypatch):
    """In the lane layout rung 1 is the JAX engine's lane ``xla_packed`` at
    the engine's precision: K2 at ``"high"``, K3 at ``"highest"``."""
    ds, qs = ds_qs
    for precision, rung1 in (("high", "v2"), ("highest", "v1")):
        eng = BatchedEngine(ds, query_batch=8, scan_impl="v1", scan_layout="lane",
                            precision=precision, device="cpu")
        seen = []
        orig = eng._search_batch
        monkeypatch.setattr(eng, "_search_batch",
                            lambda *a, **k: seen.append(k.get("impl")) or orig(*a, **k))
        suspects = np.zeros(qs.m, bool)
        suspects[:3] = True
        ids = np.zeros((qs.m, 100), np.int32)
        dists = np.zeros((qs.m, 100), np.float32)
        from hvq_tpu_torch.models.batched import pack_query_block

        Qpack = pack_query_block(qs.V.astype(np.float32), qs.qtype, qs.v, qs.l, qs.r)
        eng._rerun_suspects(Qpack, suspects, ids, dists, int(ds.n), ds.n, 100)
        assert seen[0] == rung1
