"""Card-only tests of the port: the CUDA kernels K1–K4, the level-2 select
and the TPU probe kernels against their plain versions, and the engines on
the card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where no NVIDIA GPU is present. On a GPU machine with nvcc:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures jax, which this file does
not use and such a machine need not have.)
"""

import numpy as np
import pytest
import torch

from hvq_tpu_torch.models.oracle import search_oracle
from hvq_tpu_torch.ops import kernels, probe_kernels, topk
from hvq_tpu_torch.ops.masks import query_predicate_fields
from hvq_tpu_torch.ops.scan import packed_scan_plain
from hvq_tpu_torch.tools import int8_probe, pallas_probe, v3_anatomy
from hvq_tpu_torch.utils.check import bin_scan_agreement, scan_agreement
from hvq_tpu_torch.utils.compare import compare_distances, recall_at_k
from hvq_tpu_torch.utils.formats import recompute_result_distances
from hvq_tpu_torch.utils.generators import generate_dataset, generate_queries

from torch_certificate import certificate_stress

REL_MM = 1.6e-5   # the fp32-plane certificate slack (models.batched)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _inputs(device, plane="fp32", n_pad=32768, B=40, seed=3):
    rng = np.random.default_rng(seed)
    V = rng.uniform(-6, 6, (n_pad, 128)).astype(np.float32)
    V[:, 100:] = 0.0
    qV = rng.uniform(-6, 6, (B, 128)).astype(np.float32)
    qV[:, 100:] = 0.0
    Vf = torch.from_numpy(V).to(device)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
    fields = query_predicate_fields(
        t(rng.integers(0, 4, B)), t(rng.integers(0, 4, B)),
        t(rng.uniform(-3, 0, B)), t(rng.uniform(0, 3, B)),
    )
    return (
        Vf.to(torch.bfloat16) if plane == "bf16" else Vf,
        t(rng.integers(0, 4, n_pad)), t(rng.uniform(-3, 3, n_pad)),
        (Vf * Vf).sum(1), torch.arange(n_pad, dtype=torch.int32, device=device),
        t(qV), *fields,
    )


def _agree(args, sn, **kw):
    d_k, p_k = kernels.packed_scan_v3(*args, sn, **kw)
    d_p, p_p = packed_scan_plain(*args, sn, **kw)
    torch.cuda.synchronize()
    qV, dn = args[5], args[3]
    return scan_agreement(d_k, p_k, d_p, p_p, kw["bin_top"],
                          kw["db_tile"] // 128, (qV * qV).sum(1),
                          float(dn.max()), REL_MM)


@pytest.mark.cuda
@pytest.mark.parametrize("plane", ["fp32", "bf16"])
@pytest.mark.parametrize("db_tile,R", [(1024, 1), (1024, 3), (16384, 3),
                                       (1024, 128)])
def test_kernel_matches_plain(cuda, plane, db_tile, R):
    args = _inputs(cuda, plane)
    a = _agree(args, 30000, db_tile=db_tile, bin_top=R)
    assert a["ok"], a


@pytest.mark.cuda
def test_kernel_window_matches_plain(cuda):
    args = _inputs(cuda)
    a = _agree(args, 30000, db_tile=1024, bin_top=2, row0=4096, ntw=5)
    assert a["ok"], a
    _, pos = kernels.packed_scan_v3(*args, 30000, db_tile=1024, bin_top=2,
                                    row0=4096, ntw=5)
    assert int(pos.min()) >= 4096 and int(pos.max()) < 4096 + 5 * 1024


@pytest.mark.cuda
def test_kernel_counts_only_its_launches(cuda):
    args = _inputs(cuda)
    kernels.reset_launches()
    kernels.packed_scan_v3(*args, 100, db_tile=1024, bin_top=2)
    packed_scan_plain(*args, 100, db_tile=1024, bin_top=2)
    assert kernels.launches["packed_scan_v3"] == 1


@pytest.mark.cuda
def test_kernel_wrapper_raises_instead_of_falling_back(cuda):
    args = list(_inputs(cuda))
    with pytest.raises(TypeError):
        kernels.packed_scan_v3(args[0].double(), *args[1:], 100,
                               db_tile=1024, bin_top=2)
    with pytest.raises(ValueError):
        kernels.packed_scan_v3(*args[:5], args[5].t().contiguous().t(),
                               *args[6:], 100, db_tile=1024, bin_top=2)
    with pytest.raises(ValueError):
        kernels.packed_scan_v3(*args[:5], args[5].cpu(), *args[6:], 100,
                               db_tile=1024, bin_top=2)


@pytest.mark.cuda
def test_engine_on_cuda_matches_oracle(cuda):
    from hvq_tpu_torch import get_engine

    ds = generate_dataset(40000, seed=8, categories=30)
    qs = generate_queries(48, seed=9, categories=30)
    for store in ("fp32", "bf16"):
        kernels.reset_launches()
        eng = get_engine("batched")(ds, device=cuda, query_batch=32,
                                    scan_store=store)
        ids, dists = eng.search(qs)
        assert kernels.launches["packed_scan_v3"] >= 2
        oids, odists = search_oracle(ds, qs)
        assert recall_at_k(ids, oids, dists, odists) == 1.0
        res = compare_distances(
            recompute_result_distances(ds, qs, ids.astype(np.int64)),
            recompute_result_distances(ds, qs, oids.astype(np.int64)),
        )
        assert res.ok, res


def _lane_agree(name, args, sn, db_tile, R):
    got = getattr(kernels, name)(*args, sn, db_tile=db_tile, bin_top=R)
    want = kernels.plain[name](*args, sn, db_tile=db_tile, bin_top=R)
    torch.cuda.synchronize()
    check = bin_scan_agreement if name == "bin_scan" else scan_agreement
    qV, dn = args[5], args[3]
    return check(*got, *want, R, db_tile // 128, (qV * qV).sum(1),
                 float(dn.max()), REL_MM), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["packed_scan", "packed_scan_v2"])
@pytest.mark.parametrize("db_tile,R", [(1024, 1), (1024, 4), (8192, 4),
                                       (1024, 128)])
def test_lane_kernel_matches_plain(cuda, name, db_tile, R):
    a, _ = _lane_agree(name, _inputs(cuda), 30000, db_tile, R)
    assert a["ok"], a


@pytest.mark.cuda
@pytest.mark.parametrize("db_tile,R", [(128, 2), (2048, 2), (2048, 3),
                                       (8192, 8)])
def test_bin_scan_kernel_matches_plain(cuda, db_tile, R):
    a, _ = _lane_agree("bin_scan", _inputs(cuda), 30000, db_tile, R)
    assert a["ok"], a


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["packed_scan", "packed_scan_v2", "bin_scan"])
def test_lane_kernel_masks_on_oid(cuda, name):
    """With a permuted oid the sample test keeps rows at any position."""
    args = list(_inputs(cuda))
    args[4] = torch.randperm(args[4].numel(), generator=torch.Generator().manual_seed(0)
                             ).to(cuda, torch.int32)
    a, (d, i) = _lane_agree(name, args, 10000, 2048, 3)
    assert a["ok"], a
    kept = i[torch.isfinite(d)].long()
    oid = kept if name == "bin_scan" else args[4][kept]
    assert bool((oid < 10000).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["packed_scan", "packed_scan_v2", "bin_scan"])
def test_lane_kernel_counts_only_its_launches(cuda, name):
    args = _inputs(cuda)
    kernels.reset_launches()
    getattr(kernels, name)(*args, 100, db_tile=1024, bin_top=2)
    kernels.plain[name](*args, 100, db_tile=1024, bin_top=2)
    assert kernels.launches == {**dict.fromkeys(kernels.launches, 0), name: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["packed_scan", "packed_scan_v2", "bin_scan"])
def test_lane_wrapper_raises_instead_of_falling_back(cuda, name):
    args = list(_inputs(cuda))
    fn = getattr(kernels, name)
    with pytest.raises(TypeError):              # fp32 plane only
        fn(args[0].to(torch.bfloat16), *args[1:], 100, db_tile=1024, bin_top=2)
    with pytest.raises(ValueError):
        fn(*args[:5], args[5].cpu(), *args[6:], 100, db_tile=1024, bin_top=2)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,name", [("v1", "packed_scan"),
                                       ("v2", "packed_scan_v2")])
def test_lane_engine_on_cuda_matches_oracle(cuda, impl, name):
    from hvq_tpu_torch import get_engine

    ds = generate_dataset(40000, seed=8, categories=30)
    qs = generate_queries(48, seed=9, categories=30)
    kernels.reset_launches()
    eng = get_engine("batched")(ds, device=cuda, query_batch=32, scan_impl=impl)
    ids, dists = eng.search(qs)
    assert kernels.launches[name] == 2
    oids, odists = search_oracle(ds, qs)
    assert recall_at_k(ids, oids, dists, odists) == 1.0
    res = compare_distances(
        recompute_result_distances(ds, qs, ids.astype(np.int64)),
        recompute_result_distances(ds, qs, oids.astype(np.int64)),
    )
    assert res.ok, res


def _partitioned_case(device, scan_store="fp32"):
    """A small partitioned engine on the card whose one search runs every
    route: full batches, windows on the time view, routed groups."""
    from hvq_tpu_torch import get_engine

    ds = generate_dataset(131072, seed=12, categories=30)
    rng = np.random.default_rng(13)
    mixed = generate_queries(256, seed=14, categories=30)
    l = rng.uniform(0.5, 2.5, 256).astype(np.float32)
    wide = type(mixed)(qtype=np.full(256, 2, np.int32), v=np.full(256, -1.0, np.float32),
                       l=l, r=rng.uniform(l, 4.0).astype(np.float32),
                       V=rng.uniform(-6, 6, (256, 100)).astype(np.float32))
    qs = type(mixed)(**{k: np.concatenate([getattr(mixed, k), getattr(wide, k)])
                        for k in ("qtype", "v", "l", "r", "V")})
    eng = get_engine("partitioned")(ds, device=device, db_tile=2048, query_batch=128,
                                    route_buckets=(4096,), time_view_min_queries=1,
                                    scan_store=scan_store)
    return ds, qs, eng


@pytest.mark.cuda
@pytest.mark.parametrize("scan_store", ["fp32", "bf16"])
def test_partitioned_engine_on_cuda_matches_oracle_through_k1(cuda, scan_store):
    ds, qs, eng = _partitioned_case(cuda, scan_store)
    for sp in (1.0, 0.6):
        kernels.reset_launches()
        ids, dists = eng.search(qs, sample_proportion=sp)
        route = eng.last_route
        assert route["full"] and route["windowed"] and route["routed_cat"]
        want = (route["full_batches"] + sum(route["windowed_batches"].values())
                + route["ladder"].get("rung1_runs", 0))
        assert kernels.launches == {**dict.fromkeys(kernels.launches, 0),
                                    "packed_scan_v3": want}
        oids, odists = search_oracle(ds, qs, sample_proportion=sp)
        assert recall_at_k(ids, oids, dists, odists) == 1.0
        res = compare_distances(
            recompute_result_distances(ds, qs, ids.astype(np.int64)),
            recompute_result_distances(ds, qs, oids.astype(np.int64)),
        )
        assert res.ok, res


@pytest.mark.cuda
def test_partitioned_window_k1_matches_plain_on_the_time_view(cuda):
    """One windowed batch's K1 call (its own queries, row0/ntw over the
    time view's permuted oid) against the plain version on the same
    inputs."""
    from hvq_tpu_torch.models.batched import unpack_query_block

    _, qs, eng = _partitioned_case(cuda)
    eng.search(qs)
    row0, ntw, chunk = eng.last_windows[0]
    tv = eng.index.time_view
    qb = unpack_query_block(torch.from_numpy(eng._pack_queries(qs)[chunk]).to(cuda))
    sn = row0 + tv.db_tile          # kept rows lie on both sides of sn
    args = (tv.scan_V, tv.C, tv.T, tv.d_norms, tv.oid, qb.qV, *qb[1:])
    kw = dict(db_tile=tv.db_tile, bin_top=eng.bin_top, row0=row0, ntw=ntw)
    a = _agree(args, sn, **kw)
    assert a["ok"], a
    d, pos = kernels.packed_scan_v3(*args, sn, **kw)
    kept = pos[torch.isfinite(d)].long()
    assert int(pos.min()) >= row0 and int(pos.max()) < row0 + ntw * tv.db_tile
    assert bool((tv.oid[kept] < sn).all()) and bool((kept >= sn).any())


_K1_INPUTS = {}


def _k1_inputs(device, plane, B):
    """Cached K1 inputs: 32768 rows, B queries with mixed predicates."""
    key = (plane, B)
    if key not in _K1_INPUTS:
        _K1_INPUTS[key] = _inputs(device, plane, B=B, seed=11 + B)
    return _K1_INPUTS[key]


@pytest.mark.cuda
@pytest.mark.parametrize("plane", ["fp32", "bf16"])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 6, 8, 24, 128])
@pytest.mark.parametrize("db_tile", [1024, 16384])
def test_k1_matches_plain_over_depths_tiles_and_batches(cuda, plane, R, db_tile):
    """K1's two bodies (wgmma for R ≤ 8, simt above) against the plain
    version, at batches that fill no, one and many 64-query blocks."""
    for B in (1, 40, 100, 1024):
        a = _agree(_k1_inputs(cuda, plane, B), 30000, db_tile=db_tile, bin_top=R)
        assert a["ok"], (B, a)


@pytest.mark.cuda
@pytest.mark.parametrize("plane", ["fp32", "bf16"])
@pytest.mark.parametrize("R", [3, 6, 24])
def test_k1_window_with_permuted_oid_matches_plain(cuda, plane, R):
    args = list(_inputs(cuda, plane, B=100, seed=21))
    args[4] = torch.randperm(args[4].numel(), generator=torch.Generator().manual_seed(1)
                             ).to(cuda, torch.int32)
    kw = dict(db_tile=1024, bin_top=R, row0=5 * 1024, ntw=9)
    a = _agree(args, 20000, **kw)
    assert a["ok"], a
    d, pos = kernels.packed_scan_v3(*args, 20000, **kw)
    kept = pos[torch.isfinite(d)].long()
    assert int(pos.min()) >= 5 * 1024 and int(pos.max()) < 14 * 1024
    assert bool((args[4][kept] < 20000).all())


@pytest.mark.cuda
def test_k1_counts_launches_per_body(cuda):
    args = _inputs(cuda)
    kernels.reset_launches()
    for R in (1, 3, 4, 6, 8):
        kernels.packed_scan_v3(*args, 100, db_tile=1024, bin_top=R)
    for R in (9, 24):
        kernels.packed_scan_v3(*args, 100, db_tile=1024, bin_top=R)
    assert kernels.k1_body_launches == {"wgmma": 5, "simt": 2}
    assert kernels.launches["packed_scan_v3"] == 7


@pytest.mark.cuda
@pytest.mark.parametrize("scan_store", ["fp32", "bf16"])
@pytest.mark.parametrize("scale", [1.0, 64.0, 4096.0])
def test_k1_certificate_slack_boundary_stress(cuda, scan_store, scale):
    counts = certificate_stress(cuda, scan_store, scale)
    assert counts["wgmma"] >= 1 and counts["simt"] == 0, counts


@pytest.mark.cuda
@pytest.mark.parametrize("plane", ["fp32", "bf16"])
def test_k1_exact_duplicate_keys_zero_not_negative_zero(cuda, plane):
    """Query 3's exact duplicate (row 17) comes first at a distance within
    the matmul slack of 0, and no kept distance is −0.0 (a negative key)."""
    args = list(_inputs(cuda, plane, B=40, seed=5))
    Vf = args[0].float()
    Vf[17] = args[5][3]
    args[0] = Vf.to(args[0].dtype)
    args[3] = (Vf * Vf).sum(1)
    B = args[5].shape[0]
    args[6:] = query_predicate_fields(*(torch.zeros(B, device=cuda) for _ in range(4)))
    for R in (1, 3):
        d, p = kernels.packed_scan_v3(*args, 32768, db_tile=1024, bin_top=R)
        i = int(torch.argmin(d[3]))
        slack = (8e-3 if plane == "bf16" else REL_MM) * 2 * float((args[5][3] ** 2).sum())
        assert int(p[3, i]) == 17 and 0.0 <= float(d[3, i]) <= slack
        assert not torch.signbit(d).any()


@pytest.mark.cuda
@pytest.mark.parametrize("plane", ["fp32", "bf16"])
@pytest.mark.parametrize("db_tile,R", [(16384, 1), (16384, 2), (16384, 3), (16384, 6),
                                       (1024, 3)])
def test_k1_is_deterministic(cuda, plane, db_tile, R):
    """Five runs on the same inputs give bit-identical outputs. A race in
    K1's shared-memory ring shows first as run-to-run differences: 1-D TMA
    boxes for the per-slice attributes once gave them on the fp32 plane
    over 8 tiles of 16384 rows at R ≤ 3, B=1024, with two CTAs an SM. That
    is the shape here."""
    args = _inputs(cuda, plane, n_pad=8 * 16384, B=1024, seed=41)
    kw = dict(db_tile=db_tile, bin_top=R)
    d0, p0 = kernels.packed_scan_v3(*args, 120000, **kw)
    for _ in range(4):
        d, p = kernels.packed_scan_v3(*args, 120000, **kw)
        assert torch.equal(d.view(torch.int32), d0.view(torch.int32))
        assert torch.equal(p, p0)


_LANE = ["packed_scan", "packed_scan_v2"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _LANE)
@pytest.mark.parametrize("R", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("db_tile", [1024, 8192])
def test_lane_wgmma_matches_plain_over_depths_tiles_and_batches(cuda, name, R, db_tile):
    """K3's and K2's tensor-core body (R ≤ 8) against the plain version, at
    batches that fill no, one and many 64-query blocks (B = 1000 leaves a
    ragged last one) and at 8-bin tiles, where a CTA's 32 bins span four."""
    for B in (1, 40, 100, 1000):
        a, _ = _lane_agree(name, _k1_inputs(cuda, "fp32", B), 30000, db_tile, R)
        assert a["ok"], (B, a)


@pytest.mark.cuda
@pytest.mark.parametrize("name", _LANE)
def test_lane_wgmma_reads_lanes_112_to_127(cuda, name):
    """The vectors have 100 lanes, zero-padded to 128; with data in lanes
    112–127 (the product's 8th k-step) of the plane and of one query in
    each warpgroup the result still matches plain."""
    args = list(_inputs(cuda, B=100, seed=23))
    g = torch.Generator(device=cuda).manual_seed(5)
    args[0] = args[0].clone()
    args[0][:, 112:] = torch.rand(args[0].shape[0], 16, device=cuda, generator=g) * 6 - 3
    args[3] = (args[0] * args[0]).sum(1)
    args[5] = args[5].clone()
    args[5][[3, 70], 112:] = 2.5
    for R in (1, 4):
        a, _ = _lane_agree(name, args, 30000, 1024, R)
        assert a["ok"], (R, a)


@pytest.mark.cuda
@pytest.mark.parametrize("name", _LANE)
def test_lane_kernel_counts_launches_per_body(cuda, name):
    args = _inputs(cuda)
    kernels.reset_launches()
    for R in (1, 3, 4, 6, 8):
        getattr(kernels, name)(*args, 100, db_tile=1024, bin_top=R)
    for R in (9, 32):
        getattr(kernels, name)(*args, 100, db_tile=1024, bin_top=R)
    kernels.bin_scan(*args, 100, db_tile=1024, bin_top=2)
    other = next(n for n in _LANE if n != name)
    assert kernels.lane_body_launches[name] == {"wgmma": 5, "simt": 2}
    assert kernels.lane_body_launches[other] == {"wgmma": 0, "simt": 0}
    assert kernels.launches == {**dict.fromkeys(kernels.launches, 0), name: 7,
                                "bin_scan": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("name", _LANE)
@pytest.mark.parametrize("db_tile,R", [(8192, 1), (8192, 2), (8192, 3), (8192, 4),
                                       (8192, 8), (1024, 3)])
def test_lane_wgmma_is_deterministic(cuda, name, db_tile, R):
    """Five runs on the same inputs give bit-identical outputs: B = 1024
    over 8 tiles of 8192 rows, the lane paths' shape (R = 4, rung 1 at 8),
    and 8-bin tiles."""
    args = _inputs(cuda, n_pad=8 * 8192, B=1024, seed=43)
    kw = dict(db_tile=db_tile, bin_top=R)
    fn = getattr(kernels, name)
    d0, p0 = fn(*args, 60000, **kw)
    for _ in range(4):
        d, p = fn(*args, 60000, **kw)
        assert torch.equal(d.view(torch.int32), d0.view(torch.int32))
        assert torch.equal(p, p0)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("db_tile", [1024, 2048, 8192])
def test_bin_scan_wgmma_matches_plain_over_depths_tiles_and_batches(cuda, R, db_tile):
    """K4's tensor-core body (R ≤ 8) against the plain version at batches
    that fill no, one and many 64-query blocks, every launch counted on
    that body."""
    kernels.reset_launches()
    for B in (1, 40, 100, 1000):
        a, _ = _lane_agree("bin_scan", _k1_inputs(cuda, "fp32", B), 30000, db_tile, R)
        assert a["ok"], (B, a)
    assert kernels.lane_body_launches["bin_scan"] == {"wgmma": 4, "simt": 0}


@pytest.mark.cuda
def test_bin_scan_simt_above_r8_matches_plain(cuda):
    kernels.reset_launches()
    for B in (40, 1000):
        a, _ = _lane_agree("bin_scan", _k1_inputs(cuda, "fp32", B), 30000, 2048, 16)
        assert a["ok"], (B, a)
    assert kernels.lane_body_launches["bin_scan"] == {"wgmma": 0, "simt": 2}


TIED_LANES = [5, 9, 40, 70]


def _tied_rows(device, n_pad=8192, B=100, seed=47):
    """Every bin's lanes 5, 9, 40 and 70 hold query 0 itself, so its score
    there, ‖q‖² − 2·q·q < 0, ties bit for bit across the four; the other
    queries are scaled × 3, so many of their scores are negative too. No
    predicate, no sample limit."""
    args = list(_inputs(device, n_pad=n_pad, B=B, seed=seed))
    qV = args[5].clone()
    qV[1:] *= 3.0
    V = args[0].clone().view(-1, 128, 128)
    V[:, TIED_LANES] = qV[0]
    args[0] = V.view(n_pad, 128)
    args[3] = (args[0] * args[0]).sum(1)
    args[5] = qV
    args[6:] = query_predicate_fields(*(torch.zeros(B, device=device) for _ in range(4)))
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("R", [3, 4, 8, 16])
def test_bin_scan_keeps_the_lowest_lanes_of_exact_ties(cuda, R):
    """Four rows of every bin tie bit for bit for query 0: the kept ids are
    the lowest lanes, round by round, on both bodies; scores may be
    negative."""
    args, Dt = _tied_rows(cuda), 2048
    n_pad, bins = args[0].shape[0], Dt // 128
    a, (s, i) = _lane_agree("bin_scan", args, n_pad, Dt, R)
    assert a["ok"], a
    assert bool((s[1:] < 0).any())
    s0 = s[0].view(-1, R, bins)             # (tile, round, bin)
    i0 = i[0].view(-1, R, bins)
    g = torch.arange(n_pad // 128, device=cuda).view(-1, bins)
    for j, lane in enumerate(TIED_LANES[:R]):
        assert torch.equal(i0[:, j], (g * 128 + lane).int()), (j, lane)
        assert torch.equal(s0[:, j].view(torch.int32), s0[:, 0].view(torch.int32))
    assert bool((s0[:, 0] < 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("db_tile,R", [(2048, 2), (8192, 4), (1024, 3), (8192, 8),
                                       (2048, 16)])
def test_bin_scan_is_deterministic(cuda, db_tile, R):
    args = _inputs(cuda, n_pad=8 * 8192, B=1024, seed=45)
    kw = dict(db_tile=db_tile, bin_top=R)
    s0, i0 = kernels.bin_scan(*args, 60000, **kw)
    for _ in range(4):
        s, i = kernels.bin_scan(*args, 60000, **kw)
        assert torch.equal(s.view(torch.int32), s0.view(torch.int32))
        assert torch.equal(i, i0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["trivial", "bin_scan"])
def test_thin_launch_path_runs_on_the_callers_stream(cuda, kernel):
    """Launched inside ``torch.cuda.stream(side)``, with the side stream
    queued behind a long sleep that also precedes the input's last write:
    the side stream is still busy after the launch, and the result is
    right after ``side.synchronize()``. A launch on any other stream would
    read the input before that write."""
    kernels.build()
    probe_kernels.build()             # no build inside the timed window
    side = torch.cuda.Stream()
    if kernel == "trivial":
        base = torch.randn(256, 128, device=cuda)
        want = base * 2
    else:
        args = list(_inputs(cuda, n_pad=8192, B=40, seed=49))
        base = args[5]
        want = kernels.plain["bin_scan"](*args, 8192, db_tile=2048, bin_top=2)
    side.wait_stream(torch.cuda.current_stream())

    def launch():
        x = base.clone()
        if kernel == "trivial":
            return probe_kernels.trivial(x)
        args[5] = x
        return kernels.bin_scan(*args, 8192, db_tile=2048, bin_top=2)

    with torch.cuda.stream(side):
        launch()                      # the side stream's pool holds the blocks now
        side.synchronize()            # (a new block's cudaMalloc may sync the card)
        torch.cuda._sleep(200_000_000)
        got = launch()
    assert not side.query()
    side.synchronize()
    if kernel == "trivial":
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        qV, dn = args[5], args[3]
        a = bin_scan_agreement(*got, *want, 2, 16, (qV * qV).sum(1), float(dn.max()), REL_MM)
        assert a["ok"], a


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["v1", "v2"])
@pytest.mark.parametrize("scale", [1.0, 64.0, 4096.0])
def test_lane_certificate_slack_boundary_stress(cuda, impl, scale):
    """The certificate stress through BatchedEngine(scan_impl="v1"/"v2"):
    oracle-exact at every scale, with the lane kernel on its tensor-core
    body."""
    counts = certificate_stress(cuda, "fp32", scale, scan_impl=impl)
    assert counts["wgmma"] >= 1 and counts["simt"] == 0, counts


# ------------------------------------------------------ the TPU probe kernels

def _anatomy_args(device, plane, B=100, n_pad=3 * 1024, seed=51):
    """Small anatomy inputs on the card: mixed predicates, a sample limit
    (the last 200 rows) and one bin (bin 3 of tile 1 at Dt 1024) whose rows
    are all past it; the plane fp32, bf16 or the int8 quantization."""
    Vf, C, T, dn, oid, qV, *fields = _inputs(device, n_pad=n_pad, B=B, seed=seed)
    oid = oid.clone()
    oid[1024 + 8 * torch.arange(128, device=device) + 3] += n_pad
    Vs = {"fp32": Vf, "bf16": Vf.to(torch.bfloat16),
          "int8": probe_kernels.quantize_i8(Vf)}[plane]
    return (Vs, C, T, dn, oid, qV, *fields, n_pad - 200)


@pytest.mark.cuda
@pytest.mark.parametrize("plane", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("stage", ["mm", "mmb", "dist", "mask", "pack", "full"])
@pytest.mark.parametrize("R", [1, 2, 3, 4])
def test_k1_anatomy_matches_plain(cuda, plane, stage, R):
    """Every stage on every plane against its plain version (int8 bit for
    bit), at B = 100 and 1000 (ragged query blocks); then rerun bit for bit."""
    for B in (100, 1000):
        args = _anatomy_args(cuda, plane, B=B)
        v3_anatomy.agreement(stage, plane, R, args, 1024)
        kw = dict(stage=stage, db_tile=1024, bin_top=R)
        assert torch.equal(probe_kernels.k1_anatomy(*args, **kw),
                           probe_kernels.k1_anatomy(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("plane", ["fp32", "bf16", "int8"])
def test_k1_anatomy_full_tiles_and_the_masked_bin(cuda, plane):
    """Two 16384-row tiles (full 64- or 32-bin CTAs), mm and full; mmc512
    on the bf16 plane; the all-masked bin's R entries are 0x7F800000."""
    args = _anatomy_args(cuda, plane, n_pad=2 * 16384)
    for stage, R in (("mm", 1), ("full", 2)):
        v3_anatomy.agreement(stage, plane, R, args, 16384)
    small = _anatomy_args(cuda, plane)
    if plane == "bf16":
        v3_anatomy.agreement("mmc512", plane, 1, small, 1024)
    out = probe_kernels.k1_anatomy(*small, stage="full", db_tile=1024, bin_top=3)
    assert bool((out[:, 24 + torch.arange(3) * 8 + 3] == 0x7F800000).all())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(probe_kernels.INT8_PROBE_VARIANTS))
@pytest.mark.parametrize("b,nt,dt", [(100, 2, 1024), (256, 3, 2048), (1000, 2, 1024)])
def test_int8_probe_matches_plain(cuda, variant, b, nt, dt):
    """int8 variants bit for bit, bf16 within the fp32 summation slack; B
    past one 256-query CTA and ragged blocks; reruns bit for bit."""
    data = int8_probe.inputs(seed=b, b=b, dt=dt, nt=nt, sets=1)
    qs, d = int8_probe.operands(data, variant)
    int8_probe.agreement(variant, qs[0], d)


@pytest.mark.cuda
def test_trivial_is_twice_x_bit_for_bit(cuda):
    for shape in ((256, 128), (1001,)):
        x = torch.randn(shape, device=cuda)
        assert torch.equal(probe_kernels.trivial(x).view(torch.int32),
                           (x * 2).view(torch.int32))


@pytest.mark.cuda
def test_trivial_clocks_read_events_and_host_over_the_same_calls(cuda):
    x = torch.randn(256, 128, device=cuda)
    got = pallas_probe.clocks(lambda: probe_kernels.trivial(x), 100)
    assert set(got) == {"events", "host"}
    assert got["events"] > 0 and got["host"] > 0


@pytest.mark.cuda
def test_probe_library_builds_apart_from_the_engines_library(cuda):
    """The probe kernels build into their own library; the engines'
    library keeps its sources and hash."""
    main_hash = kernels._source_hash()
    probe_kernels.build()
    kernels.build()
    assert kernels._source_hash() == main_hash
    assert main_hash in kernels.build_info["path"]
    assert probe_kernels.build_info["path"] != kernels.build_info["path"]
    assert not {p.name for p in kernels._SOURCES} & {"probes.cu", "k1_anatomy.cu"}


@pytest.mark.cuda
def test_probe_wrappers_count_their_launches_and_raise(cuda):
    probe_kernels.reset_launches()
    args = _anatomy_args(cuda, "int8")
    probe_kernels.k1_anatomy(*args, stage="pack", db_tile=1024, bin_top=2)
    data = int8_probe.inputs(seed=1, b=64, dt=1024, nt=2, sets=1)
    q, d = data["int8"][0][0], data["int8"][1]
    probe_kernels.int8_probe(q, d, "int8->i32")
    probe_kernels.int8_probe(q, d, "int8->i32", product=False)
    probe_kernels.trivial(torch.ones(8, device=cuda))
    probe_kernels.k1_anatomy_plain(*args, stage="pack", db_tile=1024, bin_top=2)
    assert dict(probe_kernels.launches) == {
        "k1_anatomy int8 pack R2": 1, "int8_probe int8->i32": 1,
        "int8_probe int8->i32 transpose only": 1, "trivial": 1}
    with pytest.raises(ValueError):
        probe_kernels.int8_probe(q, d[:, :, :512], "int8->i32")   # not contiguous
    with pytest.raises(ValueError):
        probe_kernels.trivial(torch.ones(8, device=cuda, dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("scan_store", ["fp32", "bf16"])
def test_paged_window_k1_matches_plain_with_global_oid(cuda, scan_store):
    """K1 over one resident window of the paged engine: ``oid`` holds the
    GLOBAL ids (padding rows n), the sample limit sn < n cuts the window in
    two, and positions stay local to the window."""
    from hvq_tpu_torch import get_engine

    ds = generate_dataset(40000, seed=12, categories=30)
    qs = generate_queries(64, seed=13, categories=30)
    eng = get_engine("paged")(ds, device=cuda, window_rows=16384, scan_store=scan_store)
    assert eng.scan_impl == "v3" and len(eng.windows) == 3
    w0, wlen = eng.windows[1]
    win = eng._upload_window(w0, wlen)
    Vw, Vs, Cw, Tw, dnw, oidw = win
    assert Vs.data_ptr() % 16 == 0 and int(oidw[0]) == w0
    from hvq_tpu_torch.models.batched import pack_query_block, unpack_query_block

    Q = pack_query_block(qs.V, qs.qtype, qs.v, qs.l, qs.r)
    qb = unpack_query_block(torch.from_numpy(Q).to(cuda))
    sn = w0 + wlen // 2
    args = (Vs, Cw, Tw, dnw, oidw, qb.qV, *qb[1:])
    kw = dict(db_tile=eng.db_tile, bin_top=eng.bin_top)
    d_k, p_k = kernels.packed_scan_v3(*args, sn, **kw)
    d_p, p_p = packed_scan_plain(*args, sn, **kw)
    torch.cuda.synchronize()
    rel = 8e-3 if scan_store == "bf16" else REL_MM
    a = scan_agreement(d_k, p_k, d_p, p_p, kw["bin_top"], kw["db_tile"] // 128,
                       (qb.qV * qb.qV).sum(1), float(dnw.max()), rel)
    assert a["ok"], a
    kept = p_k[torch.isfinite(d_k)]
    assert int(kept.max()) < wlen // 2 and int(kept.min()) >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("scan_store", ["fp32", "bf16"])
def test_paged_engine_on_cuda_matches_oracle_through_k1(cuda, scan_store):
    """K1 launches = windows × batches (the rerun is the streaming scan),
    all on the tensor-core body (windows of 8 tiles: R ≤ 8); each window is
    uploaded once."""
    from hvq_tpu_torch import get_engine

    ds = generate_dataset(300000, seed=14, categories=30)
    qs = generate_queries(80, seed=15, categories=30)
    eng = get_engine("paged")(ds, device=cuda, window_rows=8 * 16384, query_batch=32,
                              scan_store=scan_store)
    assert len(eng.windows) == 3 and eng.bin_top <= 8
    uploads = []
    orig = eng._upload_window
    eng._upload_window = lambda w0, wlen: uploads.append(w0) or orig(w0, wlen)
    kernels.reset_launches()
    ids, dists = eng.search(qs)
    nb = -(-qs.m // 32)
    assert kernels.launches["packed_scan_v3"] == len(eng.windows) * nb
    assert kernels.k1_body_launches == {"wgmma": len(eng.windows) * nb, "simt": 0}
    assert uploads == [w0 for w0, _ in eng.windows]
    oids, odists = search_oracle(ds, qs)
    assert recall_at_k(ids, oids, dists, odists) == 1.0
    res = compare_distances(recompute_result_distances(ds, qs, ids.astype(np.int64)),
                            recompute_result_distances(ds, qs, oids.astype(np.int64)))
    assert res.ok, res


@pytest.mark.cuda
def test_ivf_engine_on_cuda_matches_the_cpu_port_on_a_carried_index(cuda):
    """The same index (built on the CPU, carried to the card with
    ``from_host``) and queries: recomputed distances within 0.002 on the
    flat, streaming and exact routes; no scan kernel launches."""
    from hvq_tpu_torch.index.ivf import IVFIndex
    from hvq_tpu_torch.models.ivf import IVFEngine

    ds = generate_dataset(20000, seed=3, categories=8, clusters=64)
    host = IVFIndex.build(ds, cap=256, iters=4, device="cpu")
    fields = {f: getattr(host, f) for f in ("Vp", "C", "T", "oid", "d_norms", "centroids",
                                            "c_norms")}
    idx = IVFIndex.from_host(**{f: t.numpy() for f, t in fields.items()}, n=host.n,
                             cap=host.cap, scan_tile=host.scan_tile, cat_vals=host.cat_vals,
                             cat_freq=host.cat_freq, t_sample=host.t_sample, device=cuda)
    qs = generate_queries(64, seed=4, categories=8, clusters=64, centers_seed=3)
    kernels.reset_launches()
    for kw in ({}, dict(flat_budget_bytes=0)):
        want = IVFEngine(ds, index=host, device="cpu", nprobe=8, query_batch=16, **kw)
        got = IVFEngine(ds, index=idx, device=cuda, nprobe=8, query_batch=16, **kw)
        ids_w, d_w = want.search(qs)
        ids_g, d_g = got.search(qs)
        assert got.last_route == want.last_route
        np.testing.assert_allclose(
            recompute_result_distances(ds, qs, ids_g.astype(np.int64)),
            recompute_result_distances(ds, qs, ids_w.astype(np.int64)), atol=0.002, rtol=0)
        np.testing.assert_allclose(d_g, d_w, atol=0.002, rtol=0)
    assert sum(kernels.launches.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("plane", ["fp32", "bf16"])
def test_k1_and_k3_on_a_slab_view_equal_their_run_on_its_clone(cuda, plane):
    """A mesh shard's slab is a view at an offset into one upload: K1 (and
    K3 on the fp32 plane) read it through the view's own pointer, bit for
    bit what they return on a contiguous copy of the same rows."""
    from hvq_tpu_torch.parallel.mesh import make_mesh, shard_rows

    args = _inputs(cuda, plane, n_pad=4 * 16384, B=64)
    mesh = make_mesh(devices=[cuda] * 4)
    slabs = [shard_rows(mesh, a)[0] for a in args[:5]]
    kw = dict(db_tile=16384, bin_top=3)
    for j in range(1, 4):
        view = [s[j] for s in slabs]
        assert view[0].untyped_storage().data_ptr() == args[0].untyped_storage().data_ptr()
        assert view[0].data_ptr() != args[0].data_ptr()
        clone = [t.clone() for t in view]
        names = ("packed_scan_v3",) + (("packed_scan",) if plane == "fp32" else ())
        for name in names:
            fn = getattr(kernels, name)
            kw_n = kw if name == "packed_scan_v3" else dict(db_tile=8192, bin_top=4)
            got = fn(*view, *args[5:], 50000, **kw_n)
            want = fn(*clone, *args[5:], 50000, **kw_n)
            for g, w in zip(got, want):
                assert torch.equal(g.view(torch.int32), w.view(torch.int32)), (name, j)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [
    ("sharded", dict(db_tile=16384, query_batch=64)),
    ("sharded", dict(db_tile=8192, query_batch=64, scan_impl="pallas")),
    ("partitioned_sharded", dict(db_tile=16384, query_batch=64)),
])
def test_four_virtual_shards_of_one_card_equal_the_cpu_mesh(cuda, name, kw):
    """4 virtual shards of cuda:0 against the same mesh on the CPU: the
    0.002 contract and recall 1.0 both ways and against the oracle; one
    copy of the database on the card; every scan launch on the tensor-core
    body."""
    from hvq_tpu_torch import get_engine
    from hvq_tpu_torch.parallel.mesh import make_mesh

    ds = generate_dataset(300000, seed=16, categories=30)
    qs = generate_queries(128, seed=17, categories=30)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    kernels.reset_launches()
    eng = get_engine(name)(ds, mesh=make_mesh(devices=[cuda] * 4), **kw)
    ids, dists = eng.search(qs)
    held = torch.cuda.memory_allocated(cuda) - before
    cpu = get_engine(name)(ds, mesh=make_mesh(devices=["cpu"] * 4), **kw)
    c_ids, c_dists = cpu.search(qs)
    oids, odists = search_oracle(ds, qs)
    for a_ids, a_d, b_ids, b_d in ((ids, dists, c_ids, c_dists), (ids, dists, oids, odists)):
        assert recall_at_k(a_ids, b_ids, a_d, b_d) == 1.0
        res = compare_distances(recompute_result_distances(ds, qs, a_ids.astype(np.int64)),
                                recompute_result_distances(ds, qs, b_ids.astype(np.int64)))
        assert res.ok, res
    kernel = "packed_scan" if kw.get("scan_impl") == "pallas" else "packed_scan_v3"
    bodies = (kernels.k1_body_launches if kernel == "packed_scan_v3"
              else kernels.lane_body_launches[kernel])
    # every shard of every batch on the tensor-core body (R ≤ 8; a rung 1
    # at 2R > 8 may add CUDA-core launches)
    assert eng.bin_top <= 8
    assert bodies["wgmma"] >= 4 * -(-qs.m // kw["query_batch"])
    n_pad = eng.n_pad if name == "sharded" else eng.index.cat_view.n_pad
    assert held < 1.5 * n_pad * 128 * 4     # one database, not four


@pytest.mark.cuda
@pytest.mark.parametrize("plane", ["fp32", "bf16"])
@pytest.mark.parametrize("gate", [False, True])
def test_repair_on_k1_output_equals_the_repair_on_cpu(cuda, plane, gate):
    """The in-program bin repair (``common.bin_repair_candidates``) on K1's
    output on the card against the same repair on CPU copies of the same
    tensors: equal appended scores, positions and ``remaining_min``."""
    from hvq_tpu_torch.models import common
    from hvq_tpu_torch.ops.topk import smallest_k

    args = _inputs(cuda, plane, n_pad=65536, B=64)
    Vs, C, T, dn, oid, qV, ac, v, at, l, r = args
    out_s, out_i = kernels.packed_scan_v3(*args, 50000, db_tile=16384, bin_top=2)
    scores, idx = smallest_k(out_s, 128)
    cand = torch.gather(out_i, 1, idx)
    qb = common.QueryBatch(qV, ac, v, at, l, r)
    thr = (common.repair_thr_pre(scores, 100, qV, float(dn.max()), REL_MM, 2.0 ** -13,
                                 1e-6) if gate else None)
    got = common.bin_repair_candidates(out_s, scores, cand, 4, 2, 128, 16384, "axis1",
                                       C, T, oid, qb, 50000, 2, thr_pre=thr)
    cpu = lambda t: None if t is None else t.cpu()
    want = common.bin_repair_candidates(
        cpu(out_s), cpu(scores), cpu(cand), 4, 2, 128, 16384, "axis1", cpu(C), cpu(T),
        cpu(oid), common.QueryBatch(*(cpu(f) for f in qb)), 50000, 2, thr_pre=cpu(thr))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert (got[0][:, 128:] == 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["batched", "partitioned", "paged"])
def test_repair_on_the_card_repairs_a_planted_bin(cuda, name, monkeypatch):
    """One bin of K1's axis1 layout holding three near-copies of query 0
    at R = 2: the engines on the card with ``repair_bins=2`` repair it
    in-program (no ladder, no flagged window) and agree with the oracle."""
    from hvq_tpu_torch import get_engine
    from hvq_tpu_torch.index.partition import PartitionedIndex

    monkeypatch.setenv("HVQ_CERT_TERMS", "1")
    ds = generate_dataset(200000, seed=20, categories=30)
    qs = generate_queries(64, seed=21, categories=30)
    qs.qtype[:] = 0
    bins = 16384 // 128
    rows = 3 + bins * np.arange(3)
    if name == "partitioned":
        rows = PartitionedIndex.build(ds, db_tile=16384, device="cpu").cat_view.oid.numpy()[rows]
    ds.V[rows] = qs.V[0] + np.random.default_rng(5).normal(0, 1e-4, (3, 100)).astype(np.float32)
    kw = dict(device=cuda, query_batch=64, bin_top=2, repair_bins=2)
    if name == "paged":
        kw["window_rows"] = 65536
    kernels.reset_launches()
    eng = get_engine(name)(ds, **kw)
    ids, dists = eng.search(qs, k=10)
    assert kernels.launches["packed_scan_v3"] >= 1
    oids, odists = search_oracle(ds, qs, k=10)
    assert recall_at_k(ids, oids, dists, odists) == 1.0
    assert all(len(set(row)) == 10 for row in ids.tolist())
    if name == "paged":
        assert eng.last_reruns["per_window"][0] == 0
    else:
        assert eng._last_cert_terms[0] == 0 and eng.last_ladder["suspects"] == 0


@pytest.mark.cuda
def test_batched_ids_only_fetch_matches_the_full_fetch_on_the_card(cuda, monkeypatch):
    """``return_dists=False`` on the card: K1's ids as the full fetch's
    and no dists, with a ladder that runs (R = 1 flags queries) and
    without one, and the certificate's bitmask under HVQ_CERT_TERMS=1."""
    from hvq_tpu_torch import get_engine

    monkeypatch.setenv("HVQ_CERT_TERMS", "1")
    ds = generate_dataset(100000, seed=30, categories=30)
    qs = generate_queries(96, seed=31, categories=30)
    for bin_top in (None, 1):
        eng = get_engine("batched")(ds, device=cuda, query_batch=32, bin_top=bin_top)
        ids, dists = eng.search(qs)
        full_ladder, full_terms = dict(eng.last_ladder), eng._last_cert_terms.copy()
        kernels.reset_launches()
        ids2, none = eng.search(qs, return_dists=False)
        assert none is None and kernels.launches["packed_scan_v3"] >= 3
        np.testing.assert_array_equal(ids2, ids)
        assert eng.last_ladder == full_ladder
        np.testing.assert_array_equal(eng._last_cert_terms, full_terms)
        if bin_top == 1:
            assert full_ladder["suspects"] > 0, full_ladder


def _l2_stream(device, B, W, seed, inf_frac=0.3, levels=None):
    """A (B, W) candidate stream on the card: scores in [0, 100) (on
    ``levels`` values, so keys tie and the lane decides), +inf at
    ``inf_frac``, and distinct int32 positions."""
    g = torch.Generator(device=device).manual_seed(seed)
    s = torch.rand((B, W), generator=g, device=device) * 100
    if levels:
        s = torch.floor(s * (levels / 100))
    s[torch.rand((B, W), generator=g, device=device) < inf_frac] = float("inf")
    pos = torch.randperm(B * W, generator=g, device=device).view(B, W)
    return s, (pos % (1 << 30)).to(torch.int32)


def _l2_same(s, i, kp, rounds=8, nt=None, layout="axis1"):
    """The kernel's select against the plain one on the same stream, bit
    for bit: the reduce (d2, col, worst2), then (top, gids, worst2)."""
    W = s.shape[1]
    bins2 = -(-W // 128)
    rounds = min(max(rounds, -(-kp // bins2)), 128)
    src = s
    if layout == "lane" and nt:
        src = s.view(s.shape[0], nt, W // nt).transpose(1, 2).reshape(s.shape)
    got = kernels.level2_select(src, rounds, layout)
    want = topk.level2_select_plain(src, rounds, layout)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    got = topk.binned_stream_topk(s, i, kp, rounds=rounds, nt=nt, layout=layout)
    want = topk.binned_stream_topk_plain(s, i, kp, rounds=rounds, nt=nt, layout=layout)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,kp,rounds,inf_frac,levels", [
    (1024, 234624, 240, 8, 0.0, None),      # the benchmark's full batch
    (1024, 117120, 240, 8, 0.3, None),      # its windowed batch (ntw 305)
    (64, 234624, 240, 8, 0.3, 40),          # a rerun-sized batch, tied keys
    (64, 20000, 240, 8, 0.5, None),         # W not a multiple of 128
    (64, 30000, 240, 8, 0.97, 4),           # bins with fewer than 8 finite
    (64, 30000, 240, 16, 0.6, None),        # the register body at cap 16
    (64, 30000, 240, 40, 0.6, 8),           # the shared-memory body
    (16, 16384, 2048, 8, 0.2, None),        # kp asks for 16 rounds
    (16, 16384, 240, 128, 0.9, None),       # every member of a bin
])
def test_level2_select_matches_plain_bit_for_bit(cuda, B, W, kp, rounds, inf_frac, levels):
    s, i = _l2_stream(cuda, B, W, seed=B + W + rounds, inf_frac=inf_frac, levels=levels)
    s[1] = float("inf")                                  # an all-+inf row
    top, _, worst2 = _l2_same(s, i, kp, rounds)
    assert torch.isinf(top[1]).all() and torch.isinf(worst2[1])


@pytest.mark.cuda
@pytest.mark.parametrize("W,nt,rounds", [(24576, 128, 8), (31488, 123, 8),
                                         (24576, 128, 24), (20000, None, 8)])
def test_level2_select_lane_layout_matches_plain_bit_for_bit(cuda, W, nt, rounds):
    s, i = _l2_stream(cuda, 64, W, seed=W, inf_frac=0.4, levels=64)
    _l2_same(s, i, 240, rounds, nt=nt, layout="lane")


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [8, 16, 40])
def test_level2_select_is_deterministic(cuda, rounds):
    s, _ = _l2_stream(cuda, 1024, 117120, seed=rounds, inf_frac=0.3, levels=16)
    first = kernels.level2_select(s, rounds)
    for _ in range(4):
        again = kernels.level2_select(s, rounds)
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(first, again))


@pytest.mark.cuda
def test_level2_select_counts_launches_per_body(cuda):
    s, _ = _l2_stream(cuda, 8, 16384, seed=2)
    kernels.reset_launches()
    for rounds in (1, 8, 9, 16, 17, 128):
        kernels.level2_select(s, rounds)
    topk.level2_select_plain(s, 8)
    assert kernels.level2_body_launches == {"registers": 4, "shared": 2}
    assert kernels.launches == {**dict.fromkeys(kernels.launches, 0), "level2_select": 6}


@pytest.mark.cuda
def test_level2_select_raises_instead_of_falling_back(cuda):
    s, _ = _l2_stream(cuda, 8, 16384, seed=3)
    with pytest.raises(TypeError):
        kernels.level2_select(s.double(), 8)
    with pytest.raises(ValueError):
        kernels.level2_select(s.t().contiguous().t(), 8)
    with pytest.raises(ValueError):
        kernels.level2_select(torch.empty((8, 16384), device="meta"), 8)
    for rounds in (0, 129):
        with pytest.raises(ValueError):
            kernels.level2_select(s, rounds)
    with pytest.raises(ValueError):
        kernels.level2_select(s, 8, layout="lanes")


@pytest.mark.cuda
def test_partitioned_search_selects_through_the_level2_kernel(cuda, monkeypatch):
    """Full batches of 10⁶ rows stream W ≥ 16384, so every one goes through
    the kernel (its register body); the plain select in its place gives the
    same ladder, and both answers are exact."""
    from hvq_tpu_torch import get_engine

    ds = generate_dataset(1_000_000, seed=21, categories=30)
    qs = generate_queries(2048, seed=22, categories=30)
    eng = get_engine("partitioned")(ds, device=cuda)
    kernels.reset_launches()
    ids, dists = eng.search(qs)
    full = eng.last_route["full_batches"]
    assert full >= 1 and kernels.launches["level2_select"] >= full
    assert kernels.level2_body_launches == {"registers": kernels.launches["level2_select"],
                                            "shared": 0}
    ladder = dict(eng.last_ladder)
    monkeypatch.setattr(kernels, "level2_select", topk.level2_select_plain)
    ids_p, dists_p = eng.search(qs)
    assert eng.last_ladder == ladder
    sub = slice(0, 64)
    oqs = type(qs)(**{k: getattr(qs, k)[sub] for k in ("qtype", "v", "l", "r", "V")})
    oids, odists = search_oracle(ds, oqs)
    for got in (ids, ids_p):
        res = compare_distances(
            recompute_result_distances(ds, oqs, got[sub].astype(np.int64)),
            recompute_result_distances(ds, oqs, oids.astype(np.int64)))
        assert res.ok, res


@pytest.mark.cuda
@pytest.mark.parametrize("cards", [4, 1])
def test_partitioned_sharded_over_four_cards_holds_each_card_even(cuda, cards):
    """``partitioned_sharded`` on four shards at 2²² rows, the bf16 plane,
    over four cards (``cards`` 4) or as four virtual shards of one: each
    view built card by card and the time view dealt, so on four cards the
    fullest card's peak is within 1.25× of the emptiest's; the time view
    is built and wide type-2 batches take windows; the answers pass the
    benchmark's check against its plain reference
    (``hvq_bench.reference``)."""
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} cards")
    from hvq_bench.checks import exact_knn
    from hvq_tpu_torch import get_engine
    from hvq_tpu_torch.parallel.mesh import make_mesh

    devices = [torch.device("cuda", i % cards) for i in range(4)]
    held = devices[:cards]
    ds = generate_dataset(1 << 22, seed=23, categories=300)
    qs = generate_queries(4096, seed=24, categories=300)
    for card in held:
        torch.cuda.synchronize(card)
        torch.cuda.reset_peak_memory_stats(card)
    eng = get_engine("partitioned_sharded")(ds, mesh=make_mesh(devices=devices),
                                            scan_store="bf16", query_batch=256,
                                            time_view_min_queries=1)
    ids, _ = eng.search(qs)
    peaks = [torch.cuda.max_memory_allocated(card) for card in held]
    assert max(peaks) <= 1.25 * min(peaks), peaks
    route = eng.last_route
    assert route["time_view_built"] and sum(route["windowed_batches"].values()) >= 1, route
    assert [v.device for v in eng.index.time_view.shards] == devices
    cfg = dict(k=100, sample_proportion=1.0, guarantees=dict(dist_tolerance=0.002))
    db = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(held[0])
               for a in (ds.C, ds.T, ds.V))
    q = {f: torch.from_numpy(np.ascontiguousarray(getattr(qs, f))).to(held[0])
         for f in ("qtype", "v", "l", "r", "V")}
    res = exact_knn.judge(cfg, db, q, torch.from_numpy(ids.astype(np.int64)).to(held[0]))
    assert res["failed"] == 0 and res["dist_gap"] <= 0.002, res
    assert res["bad_ids"] == 0 and res["dup_ids"] == 0, res
