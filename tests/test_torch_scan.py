"""The plain version of K1 (``ops.scan.packed_scan_plain``) against the JAX
package: the v3 Pallas kernel in interpret mode and its XLA twin
``deferred_packed_scan_xla(layout="axis1")``, on the same numpy inputs.

Tolerance: the JAX package's own v3-vs-XLA tolerance (rtol=3e-6,
atol=2e-3, tests/test_pallas.py:265) plus one key quantum (2⁻¹⁶·|d|). Both
planes differ from JAX only in fp32 summation order inside the matmul
passes (bf16·bf16 products are exact in fp32 everywhere), but the packed
key truncates 7 mantissa bits, so a sum that lands a rounding apart across
a quantum boundary moves the quantized distance by a whole quantum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvq_tpu.ops import pallas_scan as jscan
from hvq_tpu_torch.ops import kernels
from hvq_tpu_torch.ops import scan as tscan

TOL = dict(rtol=3e-6 + 2.0 ** -16, atol=2e-3)


def _case(seed, n_pad=4096, B=8, plane="fp32"):
    rng = np.random.default_rng(seed)
    Vp = rng.standard_normal((n_pad, 128)).astype(np.float32)
    if plane == "bf16":
        Vp = np.array(jnp.asarray(Vp).astype(jnp.bfloat16).astype(jnp.float32))
    arrays = dict(
        Vp=Vp,
        C=rng.integers(0, 4, n_pad).astype(np.float32),
        T=rng.uniform(-3, 3, n_pad).astype(np.float32),
        dn=(Vp * Vp).sum(1).astype(np.float32),
        oid=np.arange(n_pad, dtype=np.int32),
        qV=rng.standard_normal((B, 128)).astype(np.float32),
        ac=rng.random(B) < 0.5,
        v=rng.integers(0, 4, B).astype(np.float32),
        at=rng.random(B) < 0.5,
        l=rng.uniform(-3, 0, B).astype(np.float32),
        r=rng.uniform(0, 3, B).astype(np.float32),
    )
    order = ("Vp", "C", "T", "dn", "oid", "qV", "ac", "v", "at", "l", "r")
    jx = [jnp.asarray(arrays[k]) for k in order]
    tx = [torch.from_numpy(arrays[k]) for k in order]
    if plane == "bf16":
        jx[0] = jx[0].astype(jnp.bfloat16)
        tx[0] = tx[0].to(torch.bfloat16)
    return jx, tx


def _assert_scans_agree(got, want, top=32):
    """Same top-``top`` candidate sets per query, equal positions wherever
    the quantized distances agree, distances within the plane's tolerance."""
    (gs, gi), (ws, wi) = (
        (np.asarray(a), np.asarray(b)) for a, b in (got, want)
    )
    assert gs.shape == ws.shape and gi.dtype == np.int32
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    for b in range(gs.shape[0]):
        assert set(gi[b][np.argsort(gs[b])[:top]].tolist()) == set(
            wi[b][np.argsort(ws[b])[:top]].tolist()
        )
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], **TOL)
    same = fin & (gs == ws)
    np.testing.assert_array_equal(gi[same], wi[same])


@pytest.mark.parametrize("plane", ["fp32", "bf16"])
@pytest.mark.parametrize("R", [2, 3, 8])
def test_plain_matches_v3_kernel_interpret(plane, R):
    jx, tx = _case(13, plane=plane)
    want = jscan.fused_packed_scan_v3(*jx, jnp.int32(4000), db_tile=1024,
                                      bin_top=R, interpret=True)
    got = tscan.packed_scan_plain(*tx, 4000, db_tile=1024, bin_top=R)
    _assert_scans_agree(got, want)


@pytest.mark.parametrize("plane", ["fp32", "bf16"])
@pytest.mark.parametrize("R", [2, 3, 8])
def test_plain_matches_xla_axis1_twin(plane, R):
    jx, tx = _case(14, plane=plane)
    want = jscan.deferred_packed_scan_xla(
        *jx, jnp.int32(4000), db_tile=1024, bin_top=R, layout="axis1",
    )
    got = tscan.packed_scan_plain(*tx, 4000, db_tile=1024, bin_top=R)
    _assert_scans_agree(got, want)


@pytest.mark.parametrize("plane", ["fp32", "bf16"])
def test_plain_window_matches_v3_and_twin(plane):
    jx, tx = _case(21, n_pad=8192, plane=plane)
    Dt, ntw = 1024, 3
    for row0 in (0, 2 * Dt, 5 * Dt):
        got = tscan.packed_scan_plain(*tx, 8000, db_tile=Dt, bin_top=2,
                                      row0=row0, ntw=ntw)
        for want in (
            jscan.fused_packed_scan_v3(
                *jx, jnp.int32(8000), db_tile=Dt, bin_top=2, interpret=True,
                row0=jnp.int32(row0), ntw=ntw),
            jscan.deferred_packed_scan_xla(
                *jx, jnp.int32(8000), db_tile=Dt, bin_top=2, layout="axis1",
                row0=jnp.int32(row0), ntw=ntw),
        ):
            _assert_scans_agree(got, want, top=16)
        pos = got[1][torch.isfinite(got[0])]
        assert int(pos.min()) >= row0 and int(pos.max()) < row0 + ntw * Dt


def test_sample_limit_masks_by_oid_not_position():
    """``oid < sn`` is the sample test: with ids reversed, the rows kept
    are the high positions."""
    _, tx = _case(15)
    tx[4] = torch.flip(tx[4], [0])
    dist, pos = tscan.packed_scan_plain(*tx, 100, db_tile=1024, bin_top=2)
    kept = pos[torch.isfinite(dist)]
    assert kept.numel() > 0 and int(kept.min()) >= 4096 - 100


def test_exact_duplicate_of_a_query_packs_as_plus_zero():
    """dist is clamped with `where(d > 0, d, 0)`: a −0.0 would bitcast to a
    negative key and sort before every real candidate."""
    _, tx = _case(16)
    tx[6][2] = tx[8][2] = False                 # query 2: no predicate
    tx[0][77] = tx[5][2]
    tx[3][77] = (tx[0][77] ** 2).sum()
    dist, pos = tscan.packed_scan_plain(*tx, 4096, db_tile=1024, bin_top=1)
    i = int(torch.argmin(dist[2]))
    assert int(pos[2, i]) == 77 and float(dist[2, i]) >= 0.0
    assert not torch.signbit(dist).any()


@pytest.mark.parametrize("certified", [True, False])
def test_choose_bin_top_matches_jax(certified):
    for n_pad in (1024, 4096, 16384, 65536, 1015808, 10010624):
        for kprime in (100, 128, 240, 256):
            assert tscan.choose_bin_top(n_pad, kprime, certified) == (
                jscan.choose_bin_top(n_pad, kprime, certified)
            ), (n_pad, kprime)
    for lam, j in ((0.016, 3), (1.0, 4), (0.1, 0), (5.0, 12)):
        assert tscan._poisson_tail(lam, j) == jscan._poisson_tail(lam, j)


def test_last_round_dists_matches_jax():
    rng = np.random.default_rng(17)
    out = rng.random((3, 4 * 3 * 8)).astype(np.float32)
    got = tscan.last_round_dists(torch.from_numpy(out), 4, 3, 8)
    want = jscan.last_round_dists(jnp.asarray(out), 4, 3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_wrapper_runs_plain_version_on_cpu():
    _, tx = _case(18)
    kernels.reset_launches()
    got = kernels.packed_scan_v3(*tx, 4000, db_tile=1024, bin_top=3)
    want = tscan.packed_scan_plain(*tx, 4000, db_tile=1024, bin_top=3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.launches["packed_scan_v3"] == 0   # no kernel launched


@pytest.mark.parametrize(
    "bad",
    ["fp64_plane", "int64_oid", "short_C", "strided_q", "unaligned_window",
     "bin_top_129"],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, tx = _case(19)
    kw = dict(db_tile=1024, bin_top=2)
    if bad == "fp64_plane":
        tx[0] = tx[0].double()
    elif bad == "int64_oid":
        tx[4] = tx[4].long()
    elif bad == "short_C":
        tx[1] = tx[1][:-1]
    elif bad == "strided_q":
        tx[5] = tx[5].t().contiguous().t()
    elif bad == "unaligned_window":
        kw.update(row0=100, ntw=2)
    else:
        kw.update(bin_top=129)
    with pytest.raises((TypeError, ValueError)):
        kernels.packed_scan_v3(*tx, 4000, **kw)
