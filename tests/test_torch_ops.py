"""The port's ops against the JAX package's, on the same numpy inputs.

Each comparison states its tolerance and why: fp32 sums are taken in
another order by PyTorch than by XLA, and the port's "high" and "default"
precisions are the literal bf16 passes where XLA on the CPU computes fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvq_tpu.ops import distance as jdist
from hvq_tpu.ops import masks as jmasks
from hvq_tpu.ops import topk as jtopk
from hvq_tpu_torch.ops import distance as tdist
from hvq_tpu_torch.ops import masks as tmasks
from hvq_tpu_torch.ops import topk as ttopk

# worst-order fp32 accumulation over 128 lanes, relative to Σ|xᵢyᵢ|
FP32_ACC = 128 * 2.0 ** -24


def _vecs(seed, rows, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((rows, 128))).astype(np.float32)
    x[:, 100:] = 0.0
    return x


def test_squared_norms_match_jax():
    V = _vecs(1, 300, 3.0)
    got = tdist.squared_norms(torch.from_numpy(V)).numpy()
    want = np.asarray(jdist.squared_norms(jnp.asarray(V)))
    # positive terms: relative error ≤ the accumulation bound
    np.testing.assert_allclose(got, want, rtol=FP32_ACC, atol=0)


# per-product relative error of each precision against exact fp32 products:
# "highest" none; "high" the dropped lo·lo term and the rounding of both lo
# planes (≤ 3·2⁻¹⁸); "default" two bf16 roundings (≤ 2·2⁻⁹)
@pytest.mark.parametrize(
    "precision,per_product",
    [("highest", 0.0), ("high", 3 * 2.0 ** -18), ("default", 2 * 2.0 ** -9)],
)
def test_tile_scores_match_jax(precision, per_product):
    q, V = _vecs(2, 16, 4.0), _vecs(3, 512, 4.0)
    dn = (V * V).sum(1)
    got = tdist.tile_scores(
        torch.from_numpy(q), torch.from_numpy(V), torch.from_numpy(dn),
        precision,
    ).numpy()
    want = np.asarray(jdist.tile_scores(
        jnp.asarray(q), jnp.asarray(V), jnp.asarray(dn),
        jdist.resolve_precision("highest"),
    ))
    abs_qd = np.abs(q) @ np.abs(V).T
    # the −2 cross term doubles the product error; both sides accumulate
    tol = 2 * (per_product + 2 * FP32_ACC) * abs_qd + FP32_ACC * dn[None, :]
    assert (np.abs(got - want) <= tol).all()


def test_tile_scores_high_is_the_literal_three_pass_split():
    q, V = _vecs(4, 8, 4.0), _vecs(5, 64, 4.0)
    tq, tV = torch.from_numpy(q), torch.from_numpy(V)
    hi = lambda x: x.to(torch.bfloat16).float()
    qlo, Vlo = hi(tq - hi(tq)), hi(tV - hi(tV))
    want = hi(tq) @ hi(tV).T + hi(tq) @ Vlo.T + qlo @ hi(tV).T
    assert torch.equal(tdist.dot_nt(tq, tV, "high"), want)


def test_exact_distances_match_jax():
    q, rows = _vecs(6, 8, 3.0), _vecs(7, 8 * 40, 3.0).reshape(8, 40, 128)
    got = tdist.exact_distances(torch.from_numpy(q), torch.from_numpy(rows))
    want = jdist.exact_distances(jnp.asarray(q), jnp.asarray(rows))
    # Σ(q−d)² has positive terms: relative accumulation bound
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FP32_ACC)


def _predicates(seed, B=12, Dt=256):
    rng = np.random.default_rng(seed)
    return dict(
        qtype=rng.integers(0, 4, B).astype(np.int32),
        v=rng.integers(0, 4, B).astype(np.float32),
        l=rng.uniform(-3, 0, B).astype(np.float32),
        r=rng.uniform(0, 3, B).astype(np.float32),
        C=rng.integers(0, 4, Dt).astype(np.float32),
        T=rng.uniform(-3, 3, Dt).astype(np.float32),
        gid=np.arange(Dt, dtype=np.int32) + 1000,
    )


def test_query_predicate_fields_match_jax():
    p = _predicates(8)
    args = (p["qtype"], p["v"], p["l"], p["r"])
    got = tmasks.query_predicate_fields(*(torch.from_numpy(a) for a in args))
    want = jmasks.query_predicate_fields(*(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("sn", [0, 1100, 1256, 5000])
def test_block_mask_matches_jax(sn):
    p = _predicates(9)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    j = {k: jnp.asarray(v) for k, v in p.items()}
    tf = tmasks.query_predicate_fields(t["qtype"], t["v"], t["l"], t["r"])
    jf = jmasks.query_predicate_fields(j["qtype"], j["v"], j["l"], j["r"])
    got = tmasks.block_mask(t["C"], t["T"], t["gid"], sn, *tf)
    want = jmasks.block_mask(j["C"], j["T"], j["gid"], sn, *jf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _stream(seed, B, W, inf_frac=0.2, offset=0.25):
    """Distinct positive scores (multiples of 0.25 plus ``offset``) with
    some +inf, and int32 ids."""
    rng = np.random.default_rng(seed)
    s = rng.permutation(B * W).astype(np.float32).reshape(B, W) * 0.25 + offset
    s[rng.random((B, W)) < inf_frac] = np.inf
    ids = rng.integers(0, 1 << 20, (B, W)).astype(np.int32)
    return s, ids


def _same_where_finite(got_s, got_i, want_s, want_i):
    """Equal scores; equal ids wherever the score is finite (finite
    scores are distinct, +inf slots are empty and carry any id)."""
    np.testing.assert_array_equal(got_s, want_s)
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(got_i[fin], want_i[fin])


@pytest.mark.parametrize("kprime", [1, 32, 130])
def test_merge_topk_matches_jax(kprime):
    cs, ci = _stream(10, 6, kprime)
    ts, ti = _stream(11, 6, 512, offset=0.125)   # no ties with the carry
    cs.sort(axis=1)
    got = ttopk.merge_topk(*(torch.from_numpy(x) for x in (cs, ci, ts, ti)),
                           kprime)
    want = jtopk.merge_topk(*(jnp.asarray(x) for x in (cs, ci, ts, ti)),
                            kprime, "topk")
    _same_where_finite(got[0].numpy(), got[1].numpy(),
                       np.asarray(want[0]), np.asarray(want[1]))


@pytest.mark.parametrize("k", [1, 100])
def test_final_topk_matches_jax(k):
    s, i = _stream(12, 5, 240, inf_frac=0.7)
    got = ttopk.final_topk(torch.from_numpy(s), torch.from_numpy(i), k)
    want = jtopk.final_topk(jnp.asarray(s), jnp.asarray(i), k)
    _same_where_finite(got[0].numpy(), got[1].numpy(),
                       np.asarray(want[0]), np.asarray(want[1]))


@pytest.mark.parametrize(
    "W,kp,rounds",
    [(16384, 128, 8), (23808, 240, 8), (5000, 128, 8), (16384, 2048, 8)],
)
def test_binned_stream_topk_matches_jax(W, kp, rounds):
    s, i = _stream(13, 4, W, inf_frac=0.3)
    # a saturated level-2 bin: 20 tiny scores on one strided column group
    bins2 = -(-W // 128)
    s[0, np.arange(20) * bins2] = np.arange(20, dtype=np.float32) * 1e-3
    got = ttopk.binned_stream_topk(torch.from_numpy(s), torch.from_numpy(i),
                                   kp, rounds=rounds)
    want = jtopk.binned_stream_topk(jnp.asarray(s), jnp.asarray(i), kp,
                                    rounds=rounds, layout="axis1")
    _same_where_finite(got[0].numpy(), got[1].numpy(),
                       np.asarray(want[0]), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_level2_exhausted_bins_emit_inf_at_lane_0_as_jax():
    """A bin whose finite members run out before ``rounds`` emits +inf at
    payload 0 (0x7F800000), lane 0, col = b, every round after: the rule the
    card's select copies bit for bit. Pinned on the port's plain reduce, and
    against the JAX reference through every (score, id) pair it selects."""
    B, W, rounds = 3, 5000, 8                 # 40 bins, 120 padding columns
    bins2 = -(-W // 128)
    rng = np.random.default_rng(41)
    s = np.full((B, W), np.inf, np.float32)
    finite = np.zeros((B, bins2), np.int64)
    for b in range(bins2):                    # row 0: bin b has b % 10 finite
        cols = [j * bins2 + b for j in range(b % 10) if j * bins2 + b < W]
        s[0, cols] = rng.uniform(0, 10, len(cols))
        finite[0, b] = len(cols)
    s[2] = rng.uniform(0, 10, W)              # row 1 stays all +inf
    finite[2] = [sum(j * bins2 + b < W for j in range(128)) for b in range(bins2)]
    ids = (np.arange(W, dtype=np.int32)[None] + 10000 * np.arange(B, dtype=np.int32)[:, None])

    d2, col, worst2 = ttopk.level2_select_plain(torch.from_numpy(s), rounds)
    keys = d2.view(torch.int32).view(B, rounds, bins2).numpy()
    col3 = col.view(B, rounds, bins2).numpy()
    spent = np.arange(rounds)[None, :, None] >= finite[:, None, :]
    assert spent[0].any() and spent[1].all() and not spent[2].any()
    assert (keys[spent] == ttopk.INF_KEY).all()
    assert (col3[spent] == np.broadcast_to(np.arange(bins2), col3.shape)[spent]).all()
    assert (keys[~spent] < ttopk.INF_KEY).all()

    kp = rounds * bins2                       # every slot, +inf ones too
    got = ttopk.binned_stream_topk(torch.from_numpy(s), torch.from_numpy(ids), kp,
                                   rounds=rounds)
    want = jtopk.binned_stream_topk(jnp.asarray(s), jnp.asarray(ids), kp,
                                    rounds=rounds, layout="axis1")
    for q in range(B):
        pairs = lambda sc, i: sorted(zip(np.asarray(sc)[q].tolist(), np.asarray(i)[q].tolist()))
        assert pairs(got[0], got[1]) == pairs(want[0], want[1]), q
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(worst2.numpy(), np.asarray(want[2]))
