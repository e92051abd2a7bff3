"""The port's public names against the JAX package's: the top-level
re-exports, ``register_engine``, batched's ids-only fetch, the timing
helpers and ``predicate_selectivity``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import hvq_tpu
from hvq_tpu.models import registry as jregistry
from hvq_tpu.models.batched import BatchedEngine as JaxBatchedEngine
from hvq_tpu.ops.masks import predicate_selectivity as jax_selectivity
from hvq_tpu.utils import timing as jtiming
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch.models import registry
from hvq_tpu_torch.models.batched import (BatchedEngine, pack_result, result_terms,
                                          unpack_result)
from hvq_tpu_torch.ops.masks import predicate_selectivity
from hvq_tpu_torch.utils import timing

import hvq_tpu_torch
from conftest import assert_results_match


def test_top_level_names_cover_the_jax_packages():
    public = {n for n in dir(hvq_tpu) if not n.startswith("_")}
    assert public - set(dir(hvq_tpu_torch)) == set()
    assert hvq_tpu_torch.K_DEFAULT == hvq_tpu.K_DEFAULT == 100
    assert hvq_tpu_torch.DIST_TOLERANCE == hvq_tpu.DIST_TOLERANCE
    assert (hvq_tpu_torch.VEC_DIM, hvq_tpu_torch.DATA_RECORD_DIM,
            hvq_tpu_torch.QUERY_RECORD_DIM) == (hvq_tpu.VEC_DIM, hvq_tpu.DATA_RECORD_DIM,
                                                hvq_tpu.QUERY_RECORD_DIM)


def test_top_level_readers_round_trip_the_jax_writers_files(tmp_path):
    """The README's quick start, on the port: the JAX package writes the
    files, the port's top-level readers read them back."""
    from hvq_tpu.utils import formats

    ds = generate_dataset(300, seed=3, categories=5)
    qs = generate_queries(7, seed=4, categories=5)
    formats.write_data_bin(tmp_path / "data.bin", ds)
    formats.write_query_bin(tmp_path / "query.bin", qs)
    ds2 = hvq_tpu_torch.read_data_bin(tmp_path / "data.bin")
    qs2 = hvq_tpu_torch.read_query_bin(tmp_path / "query.bin")
    assert isinstance(ds2, hvq_tpu_torch.Dataset) and isinstance(qs2, hvq_tpu_torch.QuerySet)
    np.testing.assert_array_equal(ds2.V, ds.V)
    np.testing.assert_array_equal(qs2.r, qs.r)
    ids = np.tile(np.arange(100, dtype=np.uint32), (qs.m, 1))
    hvq_tpu_torch.save_knn(ids, tmp_path / "out.bin")
    hvq_tpu_torch.save_knn_dist(ds2, qs2, ids, tmp_path / "out.bin.dist")
    np.testing.assert_array_equal(hvq_tpu_torch.read_knn(tmp_path / "out.bin"),
                                  formats.read_knn(tmp_path / "out.bin"))
    np.testing.assert_array_equal(hvq_tpu_torch.read_dist(tmp_path / "out.bin.dist"),
                                  formats.read_dist(tmp_path / "out.bin.dist"))


def test_register_engine_behaves_like_the_jax_decorator():
    jregistry.available_engines()         # the JAX built-ins, before the toy
    try:
        for reg in (jregistry, registry):
            @reg.register_engine("toy_engine")
            class Toy:
                def __init__(self, ds, **kw):
                    self.n = ds.n

            assert Toy.name == "toy_engine"
            assert reg.get_engine("toy_engine") is Toy
            assert "toy_engine" in reg.available_engines()
            assert "batched" in reg.available_engines()
            assert reg.get_engine("toy_engine")(generate_dataset(50, seed=1)).n == 50
        assert hvq_tpu_torch.register_engine is registry.register_engine
        assert hvq_tpu_torch.get_engine("toy_engine") is Toy
    finally:
        jregistry._REGISTRY.pop("toy_engine", None)
        registry._REGISTERED.pop("toy_engine", None)
    assert "toy_engine" not in registry.available_engines()
    with pytest.raises(KeyError):
        registry.get_engine("toy_engine")


@pytest.mark.parametrize("kw", [dict(), dict(repair_bins=2), dict(bin_top=1)],
                         ids=["plain", "repaired", "ladder"])
def test_batched_ids_only_fetch_gives_the_full_fetchs_ids(kw, monkeypatch):
    """``return_dists=False``: the same ids as the full fetch and None,
    on a plain run, a repaired one and one whose ladder runs (R = 1); the
    certificate's bitmask and the ladder as the full fetch's; the JAX
    engine's ids-only answer within the contract."""
    monkeypatch.setenv("HVQ_CERT_TERMS", "1")
    ds = generate_dataset(20000, seed=40, categories=20)
    qs = generate_queries(40, seed=41, categories=20)
    eng = BatchedEngine(ds, device="cpu", query_batch=16, **kw)
    ids, dists = eng.search(qs)
    ladder, terms = dict(eng.last_ladder), eng._last_cert_terms.copy()
    ids2, none = eng.search(qs, return_dists=False)
    assert none is None and ids2.dtype == np.uint32
    np.testing.assert_array_equal(ids2, ids)
    assert eng.last_ladder == ladder
    np.testing.assert_array_equal(eng._last_cert_terms, terms)
    if "bin_top" in kw:
        assert ladder["suspects"] > 0 and ladder["rung1_runs"] > 0, ladder
    jeng = JaxBatchedEngine(ds, query_batch=16, scan_impl="xla_packed",
                            **{k: v for k, v in kw.items() if k != "bin_top"})
    jids, jnone = jeng.search(qs, return_dists=False)
    assert jnone is None
    jids_full, jdists = jeng.search(qs)
    assert_results_match(ds, qs, ids2, dists, jids_full, jdists)


@pytest.mark.parametrize("with_dists", [True, False], ids=["full", "ids_only"])
def test_result_bundle_layout_round_trips(with_dists):
    """One layout for both fetches: [ids | dists bits | suspect], or
    [ids | suspect] without dists; the suspect column is the last."""
    g = torch.Generator().manual_seed(7)
    ids = torch.randint(0, 1 << 30, (5, 4), generator=g, dtype=torch.int32)
    dists = torch.rand(5, 4, generator=g)
    sus = torch.tensor([0, 3, 0, 1, 4], dtype=torch.int32)
    host = pack_result(ids, sus, dists if with_dists else None).numpy()
    assert host.shape == (5, 9 if with_dists else 5)
    i, s, d = unpack_result(host, 4)
    np.testing.assert_array_equal(i, ids.numpy())
    np.testing.assert_array_equal(s, sus.numpy() != 0)
    np.testing.assert_array_equal(result_terms(host, 4), sus.numpy())
    if with_dists:
        np.testing.assert_array_equal(d, dists.numpy())
    else:
        assert d is None


def test_track_host_memory_gives_the_jax_keys_and_types():
    with jtiming.track_host_memory() as jmem:
        buf = np.ones((1024, 1024), np.float32)
        del buf
    with timing.track_host_memory() as mem:
        buf = np.ones((1024, 1024), np.float32)
        del buf
    assert set(mem) == set(jmem) == {"current_bytes", "peak_bytes"}
    assert all(type(mem[k]) is type(jmem[k]) is int for k in mem)
    assert mem["peak_bytes"] > 4_000_000 and jmem["peak_bytes"] > 4_000_000


def test_time_fn_gives_best_of_n_seconds_as_the_jax_one(monkeypatch):
    import jax.numpy as jnp

    x = torch.ones((128, 128))
    sec = timing.time_fn(lambda a: a @ a, x, warmup=1, iters=2)
    jsec = jtiming.time_fn(lambda a: a @ a, jnp.ones((128, 128)), warmup=1, iters=2)
    assert type(sec) is type(jsec) is float and sec > 0 and jsec > 0
    calls = []
    clock = iter([0.0, 5.0, 10.0, 12.0, 20.0, 24.0])
    monkeypatch.setattr(timing, "time", SimpleNamespace(perf_counter=lambda: next(clock)))
    assert timing.time_fn(lambda: calls.append(1) or (x, [x]), warmup=2, iters=3) == 2.0
    assert len(calls) == 5


def test_time_fn_fences_only_cuda_tensors(monkeypatch):
    fenced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: fenced.append(d))

    timing._fence((torch.ones(2), {"a": [torch.zeros(1)]}, 3.0, None))
    assert fenced == []
    t = torch.ones(2)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    timing._fence({"x": (t,)})
    assert fenced == [t.device]


@pytest.mark.parametrize("seed,shape,p", [(0, (64, 512), 0.3), (1, (7,), 0.9),
                                          (2, (0, 16), 0.5), (3, (1000,), 0.0)])
def test_predicate_selectivity_equals_the_jax_functions(seed, shape, p):
    mask = np.random.default_rng(seed).random(shape) < p
    want = jax_selectivity(mask)
    assert predicate_selectivity(mask) == want
    assert predicate_selectivity(torch.from_numpy(mask)) == want
    assert type(predicate_selectivity(mask)) is float
