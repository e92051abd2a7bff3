"""The port's paged engine on the CPU against the JAX ``PagedEngine`` and
the oracle.

Windows are far smaller than the dataset, so every search crosses several
upload / scan / merge cycles. The JAX engine runs as tests/test_paged.py
runs it (``xla_packed``, and one ``pallas_v3`` case in interpret mode);
the port runs the plain packed scan (``"packed"``, the CPU's ``"auto"``)
or K1's plain version (``"v3"``). Both must give recomputed distances
within 0.002 of each other and of the oracle, the same candidate sets
wherever distances are distinct, and recall@100 = 1.0.
"""

import numpy as np
import pytest
import torch

from hvq_tpu.models.oracle import search_oracle
from hvq_tpu.models.paged import PagedEngine as JaxPagedEngine
from hvq_tpu.utils.compare import compare_distances, recall_at_k
from hvq_tpu.utils.formats import recompute_result_distances
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch import get_engine
from hvq_tpu_torch.models import batched as tbatched
from hvq_tpu_torch.models import paged as tpaged
from hvq_tpu_torch.models.paged import PagedEngine

from conftest import assert_results_match

TOL = 0.002   # the .dist contract


def _same_candidates(ds, qs, ids_a, ids_b):
    """Per query, the ids strictly inside both answers' k-th distance are
    the same set: where distances are distinct, two exact answers agree
    row for row (ties at the cut may pick either row)."""
    d_a = recompute_result_distances(ds, qs, ids_a.astype(np.int64))
    d_b = recompute_result_distances(ds, qs, ids_b.astype(np.int64))
    for q in range(qs.m):
        cut = min(d_a[q].max(), d_b[q].max())
        assert set(ids_a[q][d_a[q] < cut]) == set(ids_b[q][d_b[q] < cut]), q


@pytest.fixture(scope="module")
def jax_engines():
    """JAX engines by (dataset, keywords), built once: a JAX engine compiles
    its window program on first use, and k, sn and the query count change
    no compiled shape."""
    engines = {}

    def get(ds, jkw):
        key = (id(ds), tuple(sorted(jkw.items())))
        if key not in engines:
            engines[key] = JaxPagedEngine(ds, **jkw)
        return engines[key]

    return get


def _pair(jax_engines, ds, qs, jkw, tkw=None, k=100, sp=1.0):
    """The JAX engine and the port's on the same rows and queries, each
    held to the oracle and to each other; returns the port's engine."""
    oids, odists = search_oracle(ds, qs, k=k, sample_proportion=sp)
    jeng = jax_engines(ds, jkw)
    jids, jd = jeng.search(qs, k=k, sample_proportion=sp)
    eng = PagedEngine(ds, device="cpu", **(jkw if tkw is None else tkw))
    assert (eng.windows, eng.bin_top, eng.kprime, eng.certified, eng.window_rows) == (
        jeng.windows, jeng.bin_top, jeng.kprime, jeng.certified, jeng.window_rows)
    ids, d = eng.search(qs, k=k, sample_proportion=sp)
    assert ids.dtype == np.uint32 and d.dtype == np.float32 and ids.shape == (qs.m, k)
    assert_results_match(ds, qs, ids, d, oids, odists)
    assert recall_at_k(ids, oids, d, odists) == 1.0
    res = compare_distances(recompute_result_distances(ds, qs, ids.astype(np.int64)),
                            recompute_result_distances(ds, qs, jids.astype(np.int64)),
                            tolerance=TOL)
    assert res.ok, res
    np.testing.assert_allclose(d, jd, atol=TOL)
    _same_candidates(ds, qs, ids, jids)
    return eng


_BASE = dict(db_tile=256, query_batch=32, window_rows=512)


@pytest.mark.parametrize("case,jkw,tkw,sp", [
    # 2000 rows, 512-row windows: 4 windows, a ragged tail (2000 % 512)
    ("windows", _BASE, None, 1.0),
    ("sample_proportion", _BASE, None, 0.37),
    # bin_top=1 saturates bins: the certificate flags, the resident rerun
    # restores exactness
    ("rerun", dict(_BASE, bin_top=1), None, 1.0),
    ("bf16_plane", dict(_BASE, scan_store="bf16"), None, 1.0),
    # K1: the JAX Pallas kernel in interpret mode, the port's plain K1
    ("v3", dict(_BASE, window_rows=1024, scan_impl="pallas_v3"),
     dict(_BASE, window_rows=1024, scan_impl="v3"), 1.0),
])
def test_paged_matches_jax_and_oracle(jax_engines, small_ds, small_qs, case, jkw, tkw, sp):
    eng = _pair(jax_engines, small_ds, small_qs, jkw, tkw, sp=sp)
    assert len(eng.windows) == (2 if case == "v3" else 4)
    assert eng.scan_impl == ("v3" if case == "v3" else "packed")
    if case == "rerun":
        assert eng.last_reruns["suspects"] > 0 and eng.last_reruns["rerun_batches"] > 0


def test_paged_heavy_padding(jax_engines):
    ds = generate_dataset(1500, seed=9, categories=500)   # ~3 rows a category
    qs = generate_queries(8, seed=10, categories=500, types=(1, 3))
    _pair(jax_engines, ds, qs, dict(db_tile=128, query_batch=8, window_rows=384))


@pytest.mark.parametrize("k", [10, 128])
def test_paged_k_contract(jax_engines, small_ds, small_qs, k):
    _pair(jax_engines, small_ds, small_qs, _BASE, k=k)


def test_paged_ragged_query_count(jax_engines, small_ds):
    """m = 50 is no multiple of query_batch = 32: the running threshold
    takes ‖q‖² of the REAL queries only, never of the padded rows."""
    qs = generate_queries(50, seed=23, categories=20)
    eng = _pair(jax_engines, small_ds, qs, _BASE)
    assert eng.certified and eng.bin_top is not None


def test_paged_rerun_uploads_each_window_once(small_ds, small_qs):
    """Under constant flagging (bin_top=1) the rerun runs on the resident
    window: each window is uploaded exactly once a search."""
    eng = PagedEngine(small_ds, device="cpu", bin_top=1, **_BASE)
    uploads = []
    orig = eng._upload_window

    def counting(w0, wlen):
        uploads.append(w0)
        return orig(w0, wlen)

    eng._upload_window = counting
    oids, odists = search_oracle(small_ds, small_qs)
    ids, d = eng.search(small_qs)
    assert recall_at_k(ids, oids, d, odists) == 1.0
    assert sorted(uploads) == [w0 for w0, _ in eng.windows]
    assert eng.last_reruns["per_window"] and min(eng.last_reruns["per_window"]) > 0


def test_paged_bf16_plane_widens_kprime_and_slack(jax_engines, small_ds):
    eng = PagedEngine(small_ds, device="cpu", scan_store="bf16", **_BASE)
    jeng = jax_engines(small_ds, dict(_BASE, scan_store="bf16"))
    assert eng.kprime == jeng.kprime == 240
    assert eng._rel_mm == tbatched._CERT_REL_MM_BF16 == 8e-3
    fp32 = PagedEngine(small_ds, device="cpu", **_BASE)
    assert fp32.kprime == 128 and fp32._rel_mm == tbatched._CERT_REL_MM


def test_paged_window_holds_global_ids_and_padding(small_ds):
    """A resident window: rows padded to whole tiles and 128 lanes on the
    device, ‖d‖² of the fp32 rows, C/T +inf and oid = n on padding rows
    (so ``oid < sn`` masks them even at sample_proportion = 1), global ids
    on real rows, and the bf16 plane when asked."""
    eng = PagedEngine(small_ds, device="cpu", scan_store="bf16", **_BASE)
    w0, wlen = eng.windows[-1]
    assert (w0, wlen) == (1536, 464)
    Vw, Vs, Cw, Tw, dnw, oidw = eng._upload_window(w0, wlen)
    assert Vw.shape == (512, 128) and Vs.dtype == torch.bfloat16
    np.testing.assert_array_equal(Vw[:wlen, :100].numpy(), small_ds.V[w0:])
    assert not Vw[wlen:].any() and not Vw[:, 100:].any()
    np.testing.assert_allclose(dnw.numpy(), (Vw * Vw).sum(1).numpy(), rtol=1e-6)
    assert torch.equal(Vs, Vw.to(torch.bfloat16))
    assert torch.isinf(Cw[wlen:]).all() and torch.isinf(Tw[wlen:]).all()
    np.testing.assert_array_equal(Cw[:wlen].numpy(), small_ds.C[w0:])
    assert oidw.dtype == torch.int32
    np.testing.assert_array_equal(oidw[:wlen].numpy(), np.arange(w0, 2000))
    assert bool((oidw[wlen:] == 2000).all())


@pytest.mark.parametrize("budget,scan_store", [(2e6, "fp32"), (2e6, "bf16"), (5e5, "fp32")])
def test_paged_window_arithmetic_follows_an_explicit_budget(small_ds, budget, scan_store):
    """An explicit hbm_budget_bytes keeps the JAX meaning: whole tiles of
    budget / row bytes (528 a row, 784 with the bf16 plane)."""
    kw = dict(db_tile=256, query_batch=32, hbm_budget_bytes=budget, scan_store=scan_store)
    eng = PagedEngine(small_ds, device="cpu", **kw)
    jeng = JaxPagedEngine(small_ds, **kw)
    rows = int(budget // tpaged.row_bytes(scan_store == "bf16"))
    assert eng.window_rows == max(256, rows - rows % 256) == jeng.window_rows
    assert eng.windows == jeng.windows and eng.bin_top == jeng.bin_top


def test_paged_window_derived_from_the_cards_free_memory(monkeypatch):
    """hbm_budget_bytes=None on a card: the window fills the free memory
    less the stated headroom (1 GiB + 2·B·W·8, W = rows·R/128) and one more
    tile would not fit. The card is mocked: only the arithmetic runs."""
    free = 6 * 2 ** 30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 8 * 2 ** 30))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch, "set_float32_matmul_precision", lambda p: None)
    ds = generate_dataset(40_000_000 // 1000, seed=1)   # n is all the engine reads
    ds.V = np.broadcast_to(ds.V[:1], (40_000_000, 100))
    for store in ("fp32", "bf16"):
        eng = PagedEngine(ds, scan_store=store)
        assert eng.device.type == "cuda" and eng.scan_impl == "v3"
        Dt, B, rb = eng.db_tile, eng.query_batch, tpaged.row_bytes(store == "bf16")

        def need(rows):
            R = tpaged.choose_bin_top(rows, eng.kprime, certified=True)
            return rows * rb + 2 * B * (rows * R // 128) * 8 + tpaged._RESERVE_BYTES

        assert eng.window_rows % Dt == 0 and len(eng.windows) > 1
        assert need(eng.window_rows) <= free < need(eng.window_rows + 2 * Dt)
        assert eng.window_rows == tpaged.derived_window_rows(
            free, store == "bf16", B, eng.kprime, True) // Dt * Dt


def test_paged_registry_and_unported_options(small_ds):
    assert get_engine("paged") is PagedEngine
    with pytest.raises(NotImplementedError, match="repair_bins"):
        PagedEngine(small_ds, device="cpu", repair_bins=2, **_BASE)
    with pytest.raises(ValueError, match="scan_impl"):
        PagedEngine(small_ds, device="cpu", scan_impl="pallas", **_BASE)
    eng = PagedEngine(small_ds, device="cpu", scan_impl="xla", dispatch_group=4, **_BASE)
    assert eng.scan_impl == "stream"
