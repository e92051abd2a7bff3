"""The port's in-program bin repair and certificate forensics against the
JAX package's (``hvq_tpu.models.common.bin_repair_candidates``,
``repair_thr_pre``, ``cert_suspect`` and the engines' ``repair_bins``,
``repair_gate`` and ``HVQ_CERT_TERMS``).

The functions run on identical numpy inputs in both packages and must
agree exactly: the repair's appended scores (0 or +inf), its positions and
``remaining_min`` are selections and compares, with no arithmetic that
could round differently (``repair_thr_pre`` within 1e-6 relative: a sum
of squares in another order). The engines run ``tests/test_repair.py``'s
planted layouts (three near-copies of query 0 in ONE 128-row bin at
R = 2, or in more bins than ``repair_bins``) beside the JAX engine with
the same keywords: both at recall 1.0 against the oracle, under the 0.002
recomputed-distance contract with each other, with the same forensics
verdict, and no result row holding an id twice (the repair's dedup in the
candidates' own id space).
"""

import numpy as np
import pytest
import torch

import hvq_tpu
from hvq_tpu.models import common as jcommon
from hvq_tpu.models.oracle import search_oracle
from hvq_tpu.utils.compare import recall_at_k
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch import get_engine
from hvq_tpu_torch.index.partition import PartitionedIndex
from hvq_tpu_torch.models import common
from hvq_tpu_torch.ops.masks import query_predicate_fields
from hvq_tpu_torch.parallel.mesh import make_mesh

from conftest import assert_results_match

N = 60_000
DB_TILE = 2048
BIN = 128
BINS = DB_TILE // BIN
CPU8 = ["cpu"] * 8


# --- the functions on identical inputs ---------------------------------------

def _fn_inputs(seed, layout, row0, id_offset):
    """A packed-scan output over nt tiles (a third of the entries +inf, one
    query all +inf), its top-k′ candidates with some rows of the bins the
    repair will pick, and a view's columns (C, T, oid) around a window."""
    rng = np.random.default_rng(seed)
    B, R, nt, kp = 6, 2, 3, 16
    Dt = 512
    bins = Dt // BIN
    out_s = rng.uniform(0, 10, (B, nt * R * bins)).astype(np.float32)
    out_s[rng.random(out_s.shape) < 0.3] = np.inf
    out_s[-1] = np.inf
    n_view = (nt + 2) * Dt
    C = rng.integers(0, 4, n_view).astype(np.float32)
    T = rng.uniform(-3, 3, n_view).astype(np.float32)
    oid = rng.permutation(n_view).astype(np.int32)
    qtype = rng.integers(0, 4, B)
    v = rng.integers(0, 4, B).astype(np.float32)
    l = rng.uniform(-3, 0, B).astype(np.float32)
    r = rng.uniform(0, 3, B).astype(np.float32)
    qV = rng.uniform(-6, 6, (B, 128)).astype(np.float32)
    base = 0 if row0 is None else row0
    off = 0 if id_offset is None else id_offset
    cand_pos = rng.integers(0, nt * Dt, (B, kp)) + base + off
    # rows of the most saturated bin of each query are candidates already
    last = out_s.reshape(B, nt, R, bins)[:, :, -1, :].reshape(B, -1)
    top = last.argmin(axis=1)
    t, b = top // bins, top % bins
    s = np.arange(2)
    rows = (t[:, None] * Dt + (s * bins + b[:, None] if layout == "axis1"
                               else b[:, None] * BIN + s))
    cand_pos[:, :2] = rows + base + off
    cand_scores = np.sort(rng.uniform(0, 10, (B, kp)).astype(np.float32), axis=1)
    cand_scores[:, -3:] = np.inf
    return dict(out_s=out_s, cand_scores=cand_scores,
                cand_pos=cand_pos.astype(np.int32), nt=nt, bin_top=R, bins=bins,
                db_tile=Dt, C=C, T=T, oid=oid, qtype=qtype, v=v, l=l, r=r, qV=qV,
                sn=int(0.7 * n_view))


def _both_qb(x):
    from hvq_tpu.ops.masks import query_predicate_fields as jfields
    import jax.numpy as jnp

    jf = jfields(jnp.asarray(x["qtype"]), jnp.asarray(x["v"]), jnp.asarray(x["l"]),
                 jnp.asarray(x["r"]))
    tf = query_predicate_fields(*(torch.from_numpy(np.asarray(x[f]))
                                  for f in ("qtype", "v", "l", "r")))
    return (jcommon.QueryBatch(jnp.asarray(x["qV"]), *jf),
            common.QueryBatch(torch.from_numpy(x["qV"]), *tf))


@pytest.mark.parametrize("layout", ["axis1", "lane"])
@pytest.mark.parametrize("variant", ["plain", "window", "offset", "gate"])
def test_bin_repair_candidates_matches_jax(layout, variant):
    import jax.numpy as jnp

    row0 = 2 * 512 if variant == "window" else None
    id_offset = 1000 if variant == "offset" else None
    x = _fn_inputs(7 if layout == "axis1" else 8, layout, row0, id_offset)
    jqb, tqb = _both_qb(x)
    jthr = tthr = None
    if variant == "gate":
        jthr = jcommon.repair_thr_pre(jnp.asarray(x["cand_scores"]), 4, jqb.qV,
                                      50.0, 1.6e-5, 2.0 ** -13, 1e-6)
        tthr = common.repair_thr_pre(torch.from_numpy(x["cand_scores"]), 4, tqb.qV,
                                     50.0, 1.6e-5, 2.0 ** -13, 1e-6)
        np.testing.assert_allclose(tthr.numpy(), np.asarray(jthr), rtol=1e-6)
        tthr = torch.from_numpy(np.asarray(jthr).copy())
    args = ("nt", "bin_top", "bins", "db_tile")
    js, jp, jrem = jcommon.bin_repair_candidates(
        jnp.asarray(x["out_s"]), jnp.asarray(x["cand_scores"]),
        jnp.asarray(x["cand_pos"]), *(x[a] for a in args), layout,
        jnp.asarray(x["C"]), jnp.asarray(x["T"]), jnp.asarray(x["oid"]), jqb,
        jnp.int32(x["sn"]), 2, row0=row0, id_offset=id_offset, thr_pre=jthr)
    t = lambda a: torch.from_numpy(np.asarray(a))
    ts, tp, trem = common.bin_repair_candidates(
        t(x["out_s"]), t(x["cand_scores"]), t(x["cand_pos"]), *(x[a] for a in args),
        layout, t(x["C"]), t(x["T"]), t(x["oid"]), tqb, x["sn"], 2, row0=row0,
        id_offset=id_offset, thr_pre=tthr)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(trem.numpy(), np.asarray(jrem))
    kp = x["cand_scores"].shape[1]
    rep = ts.numpy()[:, kp:]
    # something was repaired, something was masked or deduplicated
    assert (rep == 0).any() and np.isinf(rep).any()
    assert np.isinf(rep[-1]).all()        # the all-+inf query repairs nothing


def test_repair_thr_pre_and_cert_suspect_match_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    scores = np.sort(rng.uniform(0, 100, (5, 12)).astype(np.float32), axis=1)
    qV = rng.uniform(-6, 6, (5, 128)).astype(np.float32)
    for k in (1, 12, 13):
        j = np.asarray(jcommon.repair_thr_pre(jnp.asarray(scores), k, jnp.asarray(qV),
                                              80.0, 8e-3, 2.0 ** -13, 1e-6))
        p = common.repair_thr_pre(torch.from_numpy(scores), k, torch.from_numpy(qV),
                                  80.0, 8e-3, 2.0 ** -13, 1e-6).numpy()
        np.testing.assert_allclose(p, j, rtol=1e-6)
        assert np.isinf(p).all() == (k > 12)
    flags = [rng.random(9) < 0.5 for _ in range(3)]
    for present in ((1, 1, 1), (1, 0, 1), (1, 1, 0), (1, 0, 0)):
        terms = [f if on else None for f, on in zip(flags, present)]
        for debug in (False, True):
            j = np.asarray(jcommon.cert_suspect(
                *(None if f is None else jnp.asarray(f) for f in terms), debug))
            p = common.cert_suspect(
                *(None if f is None else torch.from_numpy(f) for f in terms), debug)
            np.testing.assert_array_equal(p.numpy(), j)
            assert p.dtype == (torch.int32 if debug else torch.bool)


# --- the engines on the planted layouts ----------------------------------------

@pytest.fixture(scope="module")
def data():
    ds = generate_dataset(N, seed=1, categories=30)
    qs = generate_queries(8, seed=2, categories=30)
    qs.qtype[:] = 0
    idx = PartitionedIndex.build(ds, db_tile=DB_TILE, device="cpu")
    return ds, qs, idx.cat_view.oid.numpy()


def _copy(ds, qs):
    from hvq_tpu.utils.formats import Dataset, QuerySet

    return (Dataset(C=ds.C.copy(), T=ds.T.copy(), V=ds.V.copy()),
            QuerySet(qtype=qs.qtype.copy(), v=qs.v.copy(), l=qs.l.copy(),
                     r=qs.r.copy(), V=qs.V.copy()))


def _plant_rows(ds, qs, rows, rng, sigma=1e-4):
    ds.V[rows] = qs.V[0] + rng.normal(0, sigma, (len(rows), ds.V.shape[1])).astype(
        np.float32)


def _view_rows(oid, bin_no, n_rows):
    """Original ids at view bin ``bin_no`` of tile 0 (axis1 decode)."""
    ids = oid[bin_no + BINS * np.arange(n_rows)]
    assert (ids < N).all()
    return ids


def _axis1_rows(bin_no, n_rows, base=0):
    """Positions of bin ``bin_no`` of the tile at ``base`` (axis1)."""
    return base + bin_no + BINS * np.arange(n_rows)


def _pair(name, ds, qs, k=10, sample_proportion=1.0, port_kw=None, **kw):
    """The port's and the JAX engine ``name`` with the same keywords, both
    held to the oracle (recall 1.0) and to each other (0.002), no id twice
    in a row; returns both engines."""
    port_kw = dict(port_kw or {})
    if name in ("sharded", "partitioned_sharded"):
        port_kw.setdefault("mesh", make_mesh(devices=CPU8))
    else:
        port_kw.setdefault("device", "cpu")
    base = dict(db_tile=DB_TILE, query_batch=8, **kw)
    eng = get_engine(name)(ds, **{**base, **port_kw})
    jeng = hvq_tpu.get_engine(name)(ds, **base)
    oids, odists = search_oracle(ds, qs, k=k, sample_proportion=sample_proportion)
    ids, dists = eng.search(qs, k=k, sample_proportion=sample_proportion)
    jids, jdists = jeng.search(qs, k=k, sample_proportion=sample_proportion)
    assert recall_at_k(ids, oids, dists, odists) == 1.0
    assert recall_at_k(jids, oids, jdists, odists) == 1.0
    assert_results_match(ds, qs, ids, dists, jids, jdists)
    assert all(len(set(row)) == k for row in ids.tolist())
    return eng, jeng


@pytest.mark.parametrize("case", ["repaired", "gated", "wider", "off"])
def test_partitioned_repair_and_forensics_match_jax(data, monkeypatch, case):
    """One planted bin at R = 2 is repaired silently (terms 0, no ladder),
    also with the gather gate; five planted bins against repair_bins = 2
    still flag and end exact through the ladder; without repair the bin
    term flags. Both engines give the same bitmask for query 0."""
    monkeypatch.setenv("HVQ_CERT_TERMS", "1")
    ds, qs = _copy(*data[:2])
    rng = np.random.default_rng(5)
    if case == "wider":
        for j in range(5):
            _plant_rows(ds, qs, _view_rows(data[2], 3 + 2 * j, 3), rng)
    else:
        _plant_rows(ds, qs, _view_rows(data[2], 3, 3), rng)
    kw = dict(bin_top=2, repair_bins={"wider": 2, "off": 0}.get(case, 4),
              repair_gate=case == "gated")
    eng, jeng = _pair("partitioned", ds, qs, **kw)
    terms, jterms = eng._last_cert_terms, jeng._last_cert_terms
    assert terms.dtype == np.int32 and terms.shape == (qs.m,)
    assert (terms[0] != 0) == (jterms[0] != 0)
    if case in ("repaired", "gated"):
        assert terms[0] == 0 and eng.last_ladder["suspects"] == 0
    else:
        assert terms[0] & 1 and eng.last_ladder["suspects"] >= 1


def test_partitioned_repair_respects_time_predicate(data):
    """A wide type-2 query on the dense path: the repaired bin holds
    in-range near-copies and out-of-range exact copies of the query; the
    repair's mask keeps the latter out (``tests/test_repair.py``)."""
    ds, qs = _copy(*data[:2])
    rng = np.random.default_rng(7)
    ids = _view_rows(data[2], 9, 6)
    tv = ds.T[ids]
    assert (np.diff(tv) > 0).all()
    qs.qtype[:] = 2
    qs.l[:] = float(ds.T.min()) - 1.0
    qs.r[:] = float((tv[2] + tv[3]) / 2)
    _plant_rows(ds, qs, ids[:3], rng)
    ds.V[ids[3:]] = qs.V[0]
    _pair("partitioned", ds, qs, bin_top=2, repair_bins=4)


@pytest.mark.parametrize("name", ["partitioned", "batched"])
def test_repair_respects_sample_proportion(data, name):
    ds, qs = _copy(*data[:2])
    rows = _view_rows(data[2], 5, 3) if name == "partitioned" else _axis1_rows(5, 3)
    _plant_rows(ds, qs, rows, np.random.default_rng(8))
    kw = dict(bin_top=2, repair_bins=4)
    if name == "batched":
        kw.update(scan_impl="xla_packed")
    _pair(name, ds, qs, sample_proportion=0.5, **kw)


@pytest.mark.parametrize("impl,layout", [("xla_packed", "axis1"), ("pallas_v3", "axis1"),
                                         ("xla_packed", "lane")])
def test_batched_repair_matches_jax(data, monkeypatch, impl, layout):
    """The batched engine's repair after K1's plain version or the plain
    packed scan, in either layout (lane: a bin is 128 CONTIGUOUS rows):
    the collision is repaired silently in the port, exact in both. The
    JAX engine runs its xla_packed twin (its Pallas kernel only
    interprets on a CPU)."""
    monkeypatch.setenv("HVQ_CERT_TERMS", "1")
    ds, qs = _copy(*data[:2])
    rows = _axis1_rows(3, 3) if layout == "axis1" else np.arange(256, 259)
    _plant_rows(ds, qs, rows, np.random.default_rng(9))
    kw = dict(bin_top=2, repair_bins=4, scan_layout=layout)
    eng, jeng = _pair("batched", ds, qs, port_kw=dict(scan_impl=impl),
                      scan_impl="xla_packed", **kw)
    assert eng.scan_impl == ("v3" if impl == "pallas_v3" else "packed")
    assert (eng._last_cert_terms == 0).all() and (jeng._last_cert_terms == 0).all()
    assert eng.last_ladder["suspects"] == 0


@pytest.mark.parametrize("name", ["batched", "partitioned", "paged", "sharded",
                                  "partitioned_sharded"])
def test_repair_dedups_exact_copies(data, name):
    """Three EXACT copies of query 0 (distance 0, distinct ids) in one bin
    at R = 2: two are kept candidates, and the repair brings the bin's 128
    rows back, those two included; the dedup in the candidates' id space
    (global positions, view positions, slab positions, window positions)
    keeps every id once."""
    ds, qs = _copy(*data[:2])
    if name in ("partitioned", "partitioned_sharded"):
        rows = _view_rows(data[2], 3, 3)
    else:
        rows = _axis1_rows(3, 3)
    ds.V[rows] = qs.V[0]
    kw = dict(bin_top=2, repair_bins=2)
    if name in ("batched", "sharded"):
        kw.update(scan_impl="xla_packed")
    if name == "paged":
        kw.update(window_rows=16384)
    eng, _ = _pair(name, ds, qs, **kw)


@pytest.mark.parametrize("case", ["repaired", "wider"])
def test_sharded_repair_matches_jax(data, monkeypatch, case):
    """8 shards on the CPU: the repair per shard (slab positions), the
    shard's residual bin in the per-term minimum; five planted bins in
    shard 0 against repair_bins = 2 still flag and reach the ladder."""
    monkeypatch.setenv("HVQ_CERT_TERMS", "1")
    ds, qs = _copy(*data[:2])
    rng = np.random.default_rng(11 if case == "repaired" else 13)
    for j in range(1 if case == "repaired" else 5):
        _plant_rows(ds, qs, _axis1_rows(3 + 2 * j, 3), rng)
    eng, jeng = _pair("sharded", ds, qs, scan_impl="xla_packed", bin_top=2,
                      repair_bins=4 if case == "repaired" else 2)
    assert (eng._last_cert_terms[0] != 0) == (jeng._last_cert_terms[0] != 0)
    if case == "repaired":
        assert eng._last_cert_terms[0] == 0 and eng.last_ladder["suspects"] == 0
    else:
        assert eng._last_cert_terms[0] & 1 and eng.last_ladder["suspects"] >= 1


@pytest.mark.parametrize("case", ["repaired", "wider"])
def test_partitioned_sharded_repair_matches_jax(data, monkeypatch, case):
    monkeypatch.setenv("HVQ_CERT_TERMS", "1")
    ds, qs = _copy(*data[:2])
    rng = np.random.default_rng(5)
    for j in range(1 if case == "repaired" else 5):
        _plant_rows(ds, qs, _view_rows(data[2], 3 + 2 * j, 3), rng)
    eng, jeng = _pair("partitioned_sharded", ds, qs, bin_top=2,
                      repair_bins=4 if case == "repaired" else 2)
    assert (eng._last_cert_terms[0] != 0) == (jeng._last_cert_terms[0] != 0)
    if case == "repaired":
        assert eng._last_cert_terms[0] == 0 and eng.last_ladder["suspects"] == 0
    else:
        assert eng._last_cert_terms[0] & 1 and eng.last_ladder["suspects"] >= 1


@pytest.mark.parametrize("repair_bins", [4, 0])
def test_paged_repair_matches_jax(data, repair_bins):
    """The paged engine's per-window repair (axis1, the window's oid): the
    running threshold reads the window's residual bin, so the planted
    window flags no (window, query) pair with repair and does without."""
    ds, qs = _copy(*data[:2])
    _plant_rows(ds, qs, _axis1_rows(3, 3), np.random.default_rng(9))
    eng, _ = _pair("paged", ds, qs, bin_top=2, repair_bins=repair_bins,
                   window_rows=16384)
    flagged = eng.last_reruns["per_window"][0]
    assert (flagged == 0) if repair_bins else (flagged >= 1)
