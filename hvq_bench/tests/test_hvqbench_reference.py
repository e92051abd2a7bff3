"""The plain reference against a brute-force NumPy search, and the check
against planted faults."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from hvq_bench import reference  # noqa: E402
from hvq_bench.checks import exact_knn  # noqa: E402

K = 100


def make(n=3000, m=64, levels=300, seed=0):
    """A database whose categories hold ~n/levels rows (fewer than k: the
    tail pads) and m queries of each type 0–3."""
    rng = np.random.default_rng(seed)
    lv = np.linspace(-1, 1, levels, dtype=np.float32)
    C = lv[rng.integers(0, levels, n)]
    T = rng.uniform(-3, 3, n).astype(np.float32)
    V = rng.uniform(-6, 6, (n, 100)).astype(np.float32)
    qtype = np.repeat(np.arange(4, dtype=np.int32), m)
    M = qtype.size
    v = np.where(np.isin(qtype, (1, 3)), lv[rng.integers(0, levels, M)], -1).astype(np.float32)
    lo = rng.uniform(-3, 3, M).astype(np.float32)
    hi = (lo + (4 - lo) * rng.random(M)).astype(np.float32)
    l = np.where(np.isin(qtype, (2, 3)), lo, -1).astype(np.float32)
    r = np.where(np.isin(qtype, (2, 3)), hi, -1).astype(np.float32)
    Q = rng.uniform(-6, 6, (M, 100)).astype(np.float32)
    return (C, T, V), dict(qtype=qtype, v=v, l=l, r=r, V=Q)


def brute(db, q, sn):
    """Query at a time, float64: the contest's semantics written plainly."""
    C, T, V = db
    n = V.shape[0]
    ids, dists = [], []
    for i in range(q["qtype"].size):
        t = q["qtype"][i]
        ok = np.arange(n) < sn
        if t in (1, 3):
            ok &= C == q["v"][i]
        if t in (2, 3):
            ok &= (T >= q["l"][i]) & (T <= q["r"][i])
        cand = np.flatnonzero(ok)
        if cand.size < K:
            cand = np.r_[cand, np.arange(n - 1, n - 1 - (K - cand.size), -1)]
        d = ((V[cand].astype(np.float64) - q["V"][i].astype(np.float64)) ** 2).sum(1)
        o = np.argsort(d, kind="stable")[:K]
        ids.append(cand[o])
        dists.append(d[o])
    return np.array(ids), np.array(dists)


def tensors(db, q):
    return ([torch.from_numpy(a) for a in db],
            {k: torch.from_numpy(a) for k, a in q.items()})


@pytest.mark.parametrize("sn_share", [1.0, 0.5])
def test_reference_matches_brute_force_on_every_type(sn_share):
    db, q = make()
    n = db[2].shape[0]
    sn = int(sn_share * n)
    want_ids, want_d = brute(db, q, sn)
    (C, T, V), qt = tensors(db, q)
    ids, d, matches = reference.search(V, C, T, qt["qtype"], qt["v"], qt["l"], qt["r"],
                                       qt["V"], K, sn, q_block=48, row_block=1000)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    # every type answered, and the category types padded with tail ids
    for t in range(4):
        assert (q["qtype"] == t).sum() == 64
    assert (matches[np.isin(q["qtype"], (1, 3))] < K).all()


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159])
    y = reference.round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2 ** -10
    assert y[2] == 1.0                      # a tie rounds to even
    assert y[3] == 1.0 + 2 * 2 ** -10       # a tie rounds to even
    assert abs(float(y[4]) + 3.14159) < 2 ** -9 * 4
    assert ((y.view(torch.int32) & 0x1FFF) == 0).all()


def judge(db, q, got, sn_share=1.0):
    (C, T, V), qt = tensors(db, q)
    cfg = {"k": K, "sample_proportion": sn_share,
           "guarantees": {"dist_tolerance": 0.002}}
    return exact_knn.judge(cfg, (C, T, V), qt, torch.from_numpy(got))


def test_check_passes_the_exact_answer_and_a_tie_swap():
    db, q = make(seed=1)
    ids, _ = brute(db, q, db[2].shape[0])
    res = judge(db, q, ids)
    assert res == {"dist_gap": 0.0, "bad_ids": 0, "dup_ids": 0, "failed": 0}
    # the same answer in another order is the same answer
    res = judge(db, q, ids[:, ::-1].copy())
    assert res["failed"] == 0 and res["dist_gap"] == 0.0


def test_check_fails_a_planted_wrong_id():
    db, q = make(seed=2)
    n = db[2].shape[0]
    ids, _ = brute(db, q, n)
    bad = ids.copy()
    row = int(np.flatnonzero(q["qtype"] == 0)[5])
    # the nearest neighbour replaced by the farthest row of the database
    far = int(np.argmax(((db[2] - q["V"][row]) ** 2).sum(1)))
    bad[row, 0] = far
    res = judge(db, q, bad)
    assert res["failed"] == 1 and res["dist_gap"] > 0.002 and res["bad_ids"] == 0


def test_check_counts_predicate_breaks_and_duplicates():
    db, q = make(seed=3)
    n = db[2].shape[0]
    ids, _ = brute(db, q, n)
    row = int(np.flatnonzero(q["qtype"] == 1)[0])
    outside = int(np.flatnonzero(db[0] != q["v"][row])[0])
    got = ids.copy()
    got[row, 0] = outside                     # fails C == v, and is no tail pad
    assert judge(db, q, got)["bad_ids"] >= 1
    row0 = int(np.flatnonzero(q["qtype"] == 0)[0])
    got = ids.copy()
    got[row0, 1] = got[row0, 0]               # a row twice where no pad is due
    res = judge(db, q, got)
    assert res["dup_ids"] == 1 and res["failed"] >= 1
    got = ids.copy()
    got[row0, 2] = n + 5                      # outside the database
    assert judge(db, q, got)["bad_ids"] == 1


def test_check_honours_the_sample_limit():
    db, q = make(seed=4)
    n = db[2].shape[0]
    ids, _ = brute(db, q, n)                  # answers over all rows ...
    res = judge(db, q, ids, sn_share=0.5)     # ... judged with half of them
    assert res["bad_ids"] > 0 and res["failed"] > 0
    ids_half, _ = brute(db, q, n // 2)
    assert judge(db, q, ids_half, sn_share=0.5)["failed"] == 0


def test_control_is_judged_not_correct():
    db, q = make(n=20000, levels=30, seed=5)
    (C, T, V), qt = tensors(db, q)
    ids, _, _ = reference.search(V, C, T, qt["qtype"], qt["v"], qt["l"], qt["r"],
                                 qt["V"], K, V.shape[0], precision="tf32")
    res = judge(db, q, ids.numpy())
    assert res["dist_gap"] > 3 * 0.002 and res["failed"] > 0
