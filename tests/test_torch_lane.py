"""The lane-layout scans against the JAX package, on the same numpy inputs.

* K3 and K2's plain version, ``packed_scan_plain(layout="lane")`` at
  "highest" and "high", against ``fused_packed_scan`` and
  ``fused_packed_scan_v2`` in interpret mode and their XLA twin
  ``deferred_packed_scan_xla(layout="lane")``. Tolerance: test_torch_scan's
  ``TOL`` (the JAX rtol=3e-6, atol=2e-3 plus one key quantum), equal
  positions wherever the quantized distances agree.
* K4's plain version, ``bin_scan_plain``, against ``fused_bin_scan`` in
  interpret mode and ``fused_bin_scan_reference``: rtol 1e-6, atol 1e-4
  (tests/test_pallas.py:32-41; both sides are fp32 dots that differ only in
  summation order), ids equal, padding ids included; also at its edges:
  negative scores, exact ties (the lowest lanes kept), a bin whose only
  live row is lane 0.
* ``kernel_bin_top`` and the lane ``binned_stream_topk`` against the JAX's,
  the wrappers' CPU route and input checks, and the K4 agreement check.
* A rehearsal of K3's and K4's arithmetic on the card, the bf16×6
  emulation of fp32 that Mosaic runs for HIGHEST (``csrc/scan_wgmma.cuh``):
  a test-local six-pass product put in the plain scans' place, held to
  ``fused_packed_scan`` / ``fused_bin_scan`` in interpret mode and to fp64
  within a quarter of the certificate's slack at the stress norms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvq_tpu.ops import pallas_scan as jscan
from hvq_tpu.ops import topk as jtopk
from hvq_tpu_torch.models.batched import _CERT_REL_MM
from hvq_tpu_torch.ops import kernels
from hvq_tpu_torch.ops import scan as tscan
from hvq_tpu_torch.ops import topk as ttopk
from hvq_tpu_torch.utils.check import bin_scan_agreement, scan_agreement

from test_torch_ops import _same_where_finite, _stream
from test_torch_scan import _assert_scans_agree, _case

# (db_tile, n_pad, R): R = kernel_bin_top at Dt=512, n_pad=32768
# (tests/test_pallas.py:184), and R ∈ {2, 4} at a tile whose R·bins is
# 128-aligned, which the Pallas kernels require.
LANE_CASES = [(512, 32768, 32), (8192, 16384, 2), (8192, 16384, 4)]



def test_kernel_bin_top_case_is_the_jax_one():
    assert tscan.kernel_bin_top(512, 32768) == 32


@pytest.mark.parametrize("kernel", ["K3", "K2"])
@pytest.mark.parametrize("db_tile,n_pad,R", LANE_CASES)
def test_plain_lane_matches_pallas_kernel_interpret(kernel, db_tile, n_pad, R):
    jx, tx = _case(40 + R, n_pad=n_pad)
    sn = n_pad - 300
    if kernel == "K3":
        want = jscan.fused_packed_scan(*jx, jnp.int32(sn), db_tile=db_tile,
                                       bin_top=R, interpret=True)
    else:
        want = jscan.fused_packed_scan_v2(*jx, jnp.int32(sn), db_tile=db_tile,
                                          bin_top=R, interpret=True)
    got = tscan.packed_scan_plain(
        *tx, sn, db_tile=db_tile, bin_top=R, layout="lane",
        precision="highest" if kernel == "K3" else "high")
    _assert_scans_agree(got, want)


@pytest.mark.parametrize("db_tile,n_pad,R", LANE_CASES)
def test_plain_lane_matches_xla_lane_twin(db_tile, n_pad, R):
    jx, tx = _case(50 + R, n_pad=n_pad)
    sn = n_pad - 200
    want = jscan.deferred_packed_scan_xla(
        *jx, jnp.int32(sn), db_tile=db_tile, bin_top=R, layout="lane",
        precision=jax.lax.Precision.HIGHEST)
    got = tscan.packed_scan_plain(*tx, sn, db_tile=db_tile, bin_top=R,
                                  layout="lane", precision="highest")
    _assert_scans_agree(got, want)


@pytest.mark.parametrize("db_tile,n_pad,R", LANE_CASES)
def test_plain_lane_high_matches_xla_lane_twin_within_scan_slack(db_tile, n_pad, R):
    """XLA on the CPU runs ``Precision.HIGH`` as fp32, the plain version the
    literal 3-pass split (≈2⁻²¹ apart): a row near a key-quantum boundary
    can land one quantum off and near-tied rows of a bin can swap, so the
    outputs are held to ``scan_agreement`` with the fp32 certificate slack
    (the rule the card holds kernels to)."""
    jx, tx = _case(50 + R, n_pad=n_pad)
    sn = n_pad - 200
    want = jscan.deferred_packed_scan_xla(
        *jx, jnp.int32(sn), db_tile=db_tile, bin_top=R, layout="lane",
        precision=jax.lax.Precision.HIGH)
    got = tscan.packed_scan_plain(*tx, sn, db_tile=db_tile, bin_top=R,
                                  layout="lane", precision="high")
    qV = tx[5]
    res = scan_agreement(*got, *(torch.from_numpy(np.array(x)) for x in want),
                         R, db_tile // 128, (qV * qV).sum(1), float(tx[3].max()),
                         1.6e-5)
    assert res["ok"] and res["same_pos"] > 0.999, res


def test_plain_lane_window_matches_xla_twin():
    jx, tx = _case(22, n_pad=8192)
    Dt, ntw = 1024, 3
    for row0 in (0, 2 * Dt, 5 * Dt):
        got = tscan.packed_scan_plain(*tx, 8000, db_tile=Dt, bin_top=2,
                                      row0=row0, ntw=ntw, layout="lane")
        want = jscan.deferred_packed_scan_xla(
            *jx, jnp.int32(8000), db_tile=Dt, bin_top=2, layout="lane",
            precision=jax.lax.Precision.HIGH, row0=jnp.int32(row0), ntw=ntw)
        _assert_scans_agree(got, want, top=16)


def test_lane_positions_lie_in_their_columns_bin():
    """Lane decode: column tile·R·bins + round·bins + b holds a row of
    rows [tile·Dt + b·128, tile·Dt + (b+1)·128)."""
    _, tx = _case(23)
    Dt, R = 1024, 3
    dist, pos = tscan.packed_scan_plain(*tx, 4096, db_tile=Dt, bin_top=R,
                                        layout="lane")
    bins = Dt // 128
    col = torch.arange(dist.shape[1])
    first = (col // (R * bins)) * Dt + (col % bins) * 128
    assert bool(((pos - first >= 0) & (pos - first < 128)).all())


def _bin_problem(seed, n_pad=1024, B=16):
    """tests/test_pallas.py's random problem, as numpy arrays."""
    rng = np.random.default_rng(seed)
    Vp = rng.standard_normal((n_pad, 128)).astype(np.float32)
    a = dict(
        Vp=Vp,
        C=rng.integers(0, 5, n_pad).astype(np.float32),
        T=rng.uniform(-3, 3, n_pad).astype(np.float32),
        dn=(Vp * Vp).sum(1).astype(np.float32),
        oid=np.arange(n_pad, dtype=np.int32),
        qV=rng.standard_normal((B, 128)).astype(np.float32),
        ac=rng.random(B) < 0.5,
        v=rng.integers(0, 5, B).astype(np.float32),
        at=rng.random(B) < 0.5,
        l=rng.uniform(-3, 0, B).astype(np.float32),
        r=rng.uniform(0, 3, B).astype(np.float32),
    )
    return a


def _both(a):
    order = ("Vp", "C", "T", "dn", "oid", "qV", "ac", "v", "at", "l", "r")
    return ([jnp.asarray(a[k]) for k in order],
            [torch.from_numpy(np.ascontiguousarray(a[k])) for k in order])


def _assert_bin_scans_equal(got, want):
    (gs, gi), (ws, wi) = ((np.asarray(x), np.asarray(y)) for x, y in (got, want))
    assert gs.shape == ws.shape and gi.dtype == np.int32
    np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("db_tile,R", [(128, 2), (256, 2), (512, 2), (256, 5)])
def test_bin_scan_plain_matches_kernel_interpret_and_reference(db_tile, R):
    jx, tx = _both(_bin_problem(0))
    got = tscan.bin_scan_plain(*tx, 900, db_tile=db_tile, bin_top=R)
    for want in (
        jscan.fused_bin_scan(*jx, jnp.int32(900), db_tile=db_tile, bin_top=R,
                             interpret=True),
        jscan.fused_bin_scan_reference(*jx, jnp.int32(900), db_tile=db_tile,
                                       bin_top=R),
    ):
        _assert_bin_scans_equal(got, want)


@pytest.mark.parametrize("R", [3, 8])
def test_bin_scan_pads_with_lane0_oid_and_masks_on_oid(R):
    """T constant per 128-row bin and type-2 ranges over a few bin values:
    whole bins are empty and others hold fewer than R rows. Their padding
    entries are (+inf, oid of the bin's lane 0), with a permuted oid, and
    every reported id passes the sample test on oid."""
    a = _bin_problem(1, n_pad=2048, B=8)
    rng = np.random.default_rng(2)
    a["oid"] = rng.permutation(2048).astype(np.int32)
    a["T"] = (np.arange(2048) // 128 % 6).astype(np.float32)
    a["T"][rng.random(2048) < 0.97] = 9.0       # sparse rows in the live bins
    a["at"][:] = True
    a["l"][:], a["r"][:] = 2.0, 3.0
    jx, tx = _both(a)
    sn = 1500
    got = tscan.bin_scan_plain(*tx, sn, db_tile=512, bin_top=R)
    want = jscan.fused_bin_scan_reference(*jx, jnp.int32(sn), db_tile=512,
                                          bin_top=R)
    _assert_bin_scans_equal(got, want)
    _assert_bin_scans_equal(got, jscan.fused_bin_scan(
        *jx, jnp.int32(sn), db_tile=512, bin_top=R, interpret=True))
    s, i = (x.numpy() for x in got)
    col = np.arange(s.shape[1])
    row0 = (col // (R * 4)) * 512 + (col % 4) * 128
    pad = ~np.isfinite(s)
    assert pad.any() and np.isfinite(s).any()
    np.testing.assert_array_equal(i[pad], np.broadcast_to(a["oid"][row0], s.shape)[pad])
    assert (i[~pad] < sn).all()


def test_bin_scan_ties_go_to_the_lowest_lane():
    """Duplicate rows in one bin tie exactly; argmin's first occurrence
    decides, round after round."""
    a = _bin_problem(3, n_pad=256, B=4)
    a["Vp"][[5, 9, 70]] = a["Vp"][40]
    a["dn"] = (a["Vp"] * a["Vp"]).sum(1).astype(np.float32)
    a["qV"][0] = a["Vp"][40]
    a["ac"][:] = a["at"][:] = False
    jx, tx = _both(a)
    s, i = tscan.bin_scan_plain(*tx, 256, db_tile=256, bin_top=4)
    assert i[0, [0, 2, 4]].tolist() == [5, 9, 40]   # bin 0: rounds 0, 1, 2
    assert float(s[0, 0]) < 0                        # ‖d‖² − 2q·d = −‖q‖²
    _assert_bin_scans_equal((s, i), jscan.fused_bin_scan_reference(
        *jx, jnp.int32(256), db_tile=256, bin_top=4))


def _k4_edge_problem(case):
    """(problem, R) of one K4 edge case on 512 rows (4 bins of one tile):
    negative scores (queries × 3); rows 3, 64 and 100 of every bin equal to
    query 1, whose scores there tie bit for bit; or bin 1's lane 0 the only
    row that passes every query's type-2 range, under a permuted oid."""
    a = _bin_problem(5, n_pad=512, B=8)
    a["ac"][:] = a["at"][:] = False
    if case == "negative_scores":
        a["qV"] *= 3.0
        return a, 2
    if case == "exact_ties":
        a["Vp"].reshape(4, 128, 128)[:, [3, 64, 100]] = a["qV"][1]
        a["dn"] = (a["Vp"] * a["Vp"]).sum(1).astype(np.float32)
        return a, 3
    a["oid"] = np.random.default_rng(6).permutation(512).astype(np.int32)
    a["T"][:] = 9.0
    a["T"][128] = 2.5
    a["at"][:] = True
    a["l"][:], a["r"][:] = 2.0, 3.0
    return a, 3


@pytest.mark.parametrize("case", ["negative_scores", "exact_ties", "lane0_only_live_row"])
def test_bin_scan_plain_matches_kernel_interpret_and_reference_at_edges(case):
    """K4's edge cases: scores below zero (no ‖q‖², no clamp); exact ties,
    where every round keeps the lowest lane of the tie; a bin whose only
    live row is lane 0, whose padding entries carry the id it keeps."""
    a, R = _k4_edge_problem(case)
    jx, tx = _both(a)
    got = tscan.bin_scan_plain(*tx, 512, db_tile=512, bin_top=R)
    for want in (
        jscan.fused_bin_scan(*jx, jnp.int32(512), db_tile=512, bin_top=R, interpret=True),
        jscan.fused_bin_scan_reference(*jx, jnp.int32(512), db_tile=512, bin_top=R),
    ):
        _assert_bin_scans_equal(got, want)
    s, i = (x.numpy().reshape(8, R, 4) for x in got)   # (query, round, bin)
    if case == "negative_scores":
        assert (s[:, 0] < 0).any()
    elif case == "exact_ties":
        np.testing.assert_array_equal(i[1], np.arange(4)[None, :] * 128
                                      + np.array([3, 64, 100])[:, None])
        assert (s[1].view(np.int32) == s[1, :1].view(np.int32)).all() and (s[1] < 0).all()
    else:
        lane0 = a["oid"][128]
        assert np.isfinite(s[:, 0, 1]).all() and not np.isfinite(s[:, 1:, 1]).any()
        assert (i[:, :, 1] == lane0).all()


@pytest.mark.parametrize("certified", [True, False])
def test_kernel_bin_top_matches_jax(certified):
    for db_tile in (128, 256, 512, 1024, 2048, 8192, 16384):
        for n_pad in (16384, 32768, 65536, 1007616, 1015808, 10010624):
            for kprime in (128, 240):
                assert tscan.kernel_bin_top(db_tile, n_pad, kprime, certified) == (
                    jscan.kernel_bin_top(db_tile, n_pad, kprime, certified)
                ), (db_tile, n_pad, kprime)


@pytest.mark.parametrize(
    "W,kp,nt", [(31488, 128, 123), (16384, 128, None), (5000, 240, 4)],
)
def test_lane_binned_stream_topk_matches_jax(W, kp, nt):
    s, i = _stream(31, 4, W, inf_frac=0.3)
    # a saturated level-2 bin: 20 tiny scores in one 128-column stretch
    s[0, 256:276] = np.arange(20, dtype=np.float32) * 1e-3
    got = ttopk.binned_stream_topk(torch.from_numpy(s), torch.from_numpy(i),
                                   kp, nt=nt, layout="lane")
    want = jtopk.binned_stream_topk(jnp.asarray(s), jnp.asarray(i), kp,
                                    nt=nt, layout="lane")
    _same_where_finite(got[0].numpy(), got[1].numpy(),
                       np.asarray(want[0]), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("name", ["packed_scan", "packed_scan_v2", "bin_scan"])
def test_lane_wrapper_runs_plain_version_on_cpu(name):
    _, tx = _case(18)
    kernels.reset_launches()
    got = getattr(kernels, name)(*tx, 4000, db_tile=1024, bin_top=3)
    want = kernels.plain[name](*tx, 4000, db_tile=1024, bin_top=3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert set(kernels.launches.values()) == {0}     # no kernel launched


@pytest.mark.parametrize(
    "bad", ["bf16_plane", "int64_oid", "strided_q", "ragged_tile", "bin_top_129"],
)
@pytest.mark.parametrize("name", ["packed_scan", "packed_scan_v2", "bin_scan"])
def test_lane_wrapper_rejects_what_the_kernel_does_not_take(name, bad):
    _, tx = _case(19)
    kw = dict(db_tile=1024, bin_top=2)
    if bad == "bf16_plane":                # K2-K4 read the fp32 plane only
        tx[0] = tx[0].to(torch.bfloat16)
    elif bad == "int64_oid":
        tx[4] = tx[4].long()
    elif bad == "strided_q":
        tx[5] = tx[5].t().contiguous().t()
    elif bad == "ragged_tile":             # 4096 rows are not 3072-row tiles
        kw.update(db_tile=3072)
    else:
        kw.update(bin_top=129)
    with pytest.raises((TypeError, ValueError)):
        getattr(kernels, name)(*tx, 4000, **kw)


def test_bin_scan_agreement_flags_ids_scores_and_padding():
    a = _bin_problem(4, n_pad=1024, B=8)
    a["T"][:512] = 9.0                     # empty bins in tile 0 for type-2 queries
    _, tx = _both(a)
    s, i = tscan.bin_scan_plain(*tx, 1000, db_tile=512, bin_top=3)
    qn = (tx[5] ** 2).sum(1)
    check = lambda s2, i2: bin_scan_agreement(s2, i2, s, i, 3, 4, qn, 150.0, 1.6e-5)
    assert check(s, i)["ok"]
    fin = torch.nonzero(torch.isfinite(s.reshape(-1)))[0, 0]
    wrong_id = i.clone().view(-1)
    wrong_id[fin] += 1
    assert not check(s, wrong_id.view_as(i))["ok"]
    wrong_s = s.clone().view(-1)
    wrong_s[fin] += 1.0
    assert not check(wrong_s.view_as(s), i)["ok"]
    pad = torch.nonzero(~torch.isfinite(s.reshape(-1)))[0, 0]
    wrong_pad = i.clone().view(-1)
    wrong_pad[pad] += 1
    res = check(s, wrong_pad.view_as(i))
    assert not res["ok"] and not res["pad_ids_ok"]


def _bf16x6(q, V):
    """q·Vᵀ as the bf16×6 emulation of fp32: each operand split into three
    bf16 parts (hi = bf16_rn(x), mid = bf16_rn(x − hi), lo = bf16_rn(x − hi
    − mid)), the six products K3's tensor-core body chains, smallest first,
    each exact in fp32 (bf16·bf16), summed in fp32."""
    def parts(x):
        out, rest = [], x.float()
        for _ in range(3):
            out.append(rest.to(torch.bfloat16).float())
            rest = rest - out[-1]
        return out

    (qh, qm, ql), (Vh, Vm, Vl) = parts(q), parts(V)
    acc = torch.zeros(q.shape[:-1] + V.shape[-2:-1], dtype=torch.float32)
    for a, b in ((ql, Vh), (qm, Vm), (qh, Vl), (qm, Vh), (qh, Vm), (qh, Vh)):
        acc = acc + a @ b.transpose(-1, -2)
    return acc


@pytest.fixture
def six_pass(monkeypatch):
    """The plain scan with its "highest" product replaced by the six-pass one."""
    dot = tscan.dot_nt
    monkeypatch.setattr(tscan, "dot_nt", lambda q, V, precision: (
        _bf16x6(q, V) if precision == "highest" else dot(q, V, precision)))


@pytest.mark.parametrize("db_tile,n_pad,R", LANE_CASES)
def test_six_pass_product_matches_pallas_kernel_interpret(six_pass, db_tile, n_pad, R):
    jx, tx = _case(60 + R, n_pad=n_pad)
    sn = n_pad - 300
    want = jscan.fused_packed_scan(*jx, jnp.int32(sn), db_tile=db_tile, bin_top=R,
                                   interpret=True)
    got = tscan.packed_scan_plain(*tx, sn, db_tile=db_tile, bin_top=R, layout="lane",
                                  precision="highest")
    _assert_scans_agree(got, want)


@pytest.mark.parametrize("scale", [1.0, 64.0, 4096.0])
def test_six_pass_product_stays_inside_a_quarter_of_the_certificate_slack(six_pass, scale):
    """The certificate stress layout (data and queries × scale, 64 rows on a
    near-exact sphere around query 0), the lane paths' Dt = 8192 and R = 4:
    every kept distance against its fp64 value, net of the key's own 2⁻¹⁶
    truncation, uses at most a quarter of ``_CERT_REL_MM·(‖q‖² + max‖d‖²)``
    (chip_smoke holds the kernel itself to half)."""
    n_pad, B = 16384, 16
    rng = np.random.default_rng(33)
    V = rng.uniform(-6, 6, (n_pad, 128)).astype(np.float32) * np.float32(scale)
    q = rng.uniform(-6, 6, (B, 128)).astype(np.float32) * np.float32(scale)
    V[:, 100:] = q[:, 100:] = 0.0
    dirs = rng.standard_normal((64, 100))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radius = 0.1 * scale * (1.0 + 1e-7 * rng.standard_normal((64, 1)))
    V[:64, :100] = (q[0, :100].astype(np.float64) + radius * dirs).astype(np.float32)
    Vt, qt = torch.from_numpy(V), torch.from_numpy(q)
    dn = (Vt * Vt).sum(1)
    z, f = torch.zeros(n_pad), torch.zeros(B, dtype=torch.bool)
    d, pos = tscan.packed_scan_plain(
        Vt, z, z, dn, torch.arange(n_pad, dtype=torch.int32), qt, f, torch.zeros(B), f,
        torch.zeros(B), torch.zeros(B), n_pad, db_tile=8192, bin_top=4, layout="lane",
        precision="highest")
    fin = torch.isfinite(d)
    qi = torch.nonzero(fin)[:, 0]
    true = ((qt.double()[qi] - Vt.double()[pos[fin].long()]) ** 2).sum(1)
    slack = _CERT_REL_MM * ((qt.double() ** 2).sum(1)[qi] + float(dn.max()))
    ratio = float((((d[fin].double() - true).abs() - 2.0 ** -16 * true) / slack).max())
    assert fin.all() and ratio <= 0.25, ratio
    # bin 0 is query 0's sphere (rows 0-63): its R kept rows lie on it
    assert bool((pos[0].view(2, 4, 64)[0, :, 0] < 64).all())


@pytest.mark.parametrize("scale", [1.0, 64.0, 4096.0])
def test_six_pass_k4_stays_inside_a_quarter_of_the_certificate_slack(six_pass, scale):
    """K4's tensor-core arithmetic (the six-pass product, then ‖d‖² − 2·q·d
    in one rounding) rehearsed on the CPU at its Dt = 2048, R = 2 over the
    certificate stress layout: every kept score + ‖q‖² against its fp64
    distance (no key term: K4 is unpacked) uses at most a quarter of
    ``_CERT_REL_MM·(‖q‖² + max‖d‖²)``, and the plain version with it
    matches fused_bin_scan in interpret mode (chip_smoke holds the kernel
    itself to half)."""
    n_pad, B = 16384, 16
    rng = np.random.default_rng(34)
    V = rng.uniform(-6, 6, (n_pad, 128)).astype(np.float32) * np.float32(scale)
    q = rng.uniform(-6, 6, (B, 128)).astype(np.float32) * np.float32(scale)
    V[:, 100:] = q[:, 100:] = 0.0
    dirs = rng.standard_normal((64, 100))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radius = 0.1 * scale * (1.0 + 1e-7 * rng.standard_normal((64, 1)))
    V[:64, :100] = (q[0, :100].astype(np.float64) + radius * dirs).astype(np.float32)
    Vt, qt = torch.from_numpy(V), torch.from_numpy(q)
    dn = (Vt * Vt).sum(1)
    z, f = torch.zeros(n_pad), torch.zeros(B, dtype=torch.bool)
    s, ids = tscan.bin_scan_plain(Vt, z, z, dn, torch.arange(n_pad, dtype=torch.int32), qt,
                                  f, torch.zeros(B), f, torch.zeros(B), torch.zeros(B), n_pad,
                                  db_tile=2048, bin_top=2)
    qn = (qt.double() ** 2).sum(1)[:, None].expand_as(s)
    true = ((qt.double()[:, None, :] - Vt.double()[ids.long()]) ** 2).sum(2)
    slack = _CERT_REL_MM * (qn + float(dn.max()))
    ratio = float(((s.double() + qn - true).abs() / slack).max())
    assert torch.isfinite(s).all() and ratio <= 0.25, ratio
    if scale == 1.0:
        # the ordering at the tie-free scale is the interpret kernel's
        jx = [jnp.asarray(x.numpy()) for x in (Vt, z, z, dn)]
        want = jscan.fused_bin_scan(
            *jx, jnp.arange(n_pad, dtype=jnp.int32), jnp.asarray(q), jnp.zeros(B, bool),
            jnp.zeros(B), jnp.zeros(B, bool), jnp.zeros(B), jnp.zeros(B), jnp.int32(n_pad),
            db_tile=2048, bin_top=2, interpret=True)
        assert bin_scan_agreement(s, ids, torch.from_numpy(np.array(want[0])),
                                  torch.from_numpy(np.array(want[1])), 2, 16,
                                  (qt ** 2).sum(1), float(dn.max()), _CERT_REL_MM)["ok"]


def test_reset_launches_clears_the_per_body_counts_and_cpu_runs_count_nothing():
    _, tx = _case(24)
    kernels.reset_launches()
    for name in ("packed_scan", "packed_scan_v2", "bin_scan"):
        for R in (4, 16):            # a tensor-core depth and a CUDA-core one
            getattr(kernels, name)(*tx, 4000, db_tile=1024, bin_top=R)
    assert kernels.lane_body_launches == {
        "packed_scan": {"wgmma": 0, "simt": 0},
        "packed_scan_v2": {"wgmma": 0, "simt": 0},
        "bin_scan": {"wgmma": 0, "simt": 0}}
    assert set(kernels.launches.values()) == {0}
    kernels.lane_body_launches["packed_scan"]["wgmma"] = 3
    kernels.lane_body_launches["packed_scan_v2"]["simt"] = 2
    kernels.k1_body_launches["wgmma"] = 1
    kernels.launches["packed_scan_v2"] = 5
    kernels.reset_launches()
    assert all(v == 0 for c in kernels.lane_body_launches.values() for v in c.values())
    assert set(kernels.k1_body_launches.values()) == {0}
    assert set(kernels.launches.values()) == {0}
