"""The comparison that decides ``correct`` for an exact hybrid k-NN
deployment: the ids the timed calls returned, judged against the plain
reference (``hvq_bench/reference.py``) as the contest's ``compare_data``
judges a result file, by distances and not by ids (near-ties may swap).

For each answer drawn:

* ``dist_gap``: the widest |Δ| between the float64 distances of the
  returned ids, sorted, and the reference's k least, slot by slot. The
  configuration states its limit (``guarantees.dist_tolerance``, the
  contest's 0.002);
* ``bad_ids``: returned ids outside the database, or failing the query's
  predicate or sample limit without being one of its tail pads (limit 0);
* ``dup_ids``: an id returned more often than it may be: once as a row
  that passes and once as a tail pad (limit 0).

The harness adds ``missing``: calls that returned no answer of the right
shape (limit 0).
"""

from __future__ import annotations

import torch

from hvq_bench import reference


def limits(cfg: dict) -> dict:
    return {"dist_gap": float(cfg["guarantees"]["dist_tolerance"]),
            "bad_ids": 0, "dup_ids": 0, "missing": 0}


def judge(cfg: dict, db, q: dict, got, block: int = 1024) -> dict:
    """Numbers of the answers ``got`` ((s, k) int64 tensor on the device of
    ``db`` = (C, T, V)) to the queries ``q`` (dict of (s,) / (s, dim)
    tensors there): {"dist_gap", "bad_ids", "dup_ids"} and ``failed``, the
    answers that break a limit."""
    C, T, V = db
    n, k = V.shape[0], int(cfg["k"])
    sn = int(cfg["sample_proportion"] * n)
    lim = limits(cfg)
    gap, bad, dup, failed = 0.0, 0, 0, 0
    for s0 in range(0, got.shape[0], block):
        sl = slice(s0, s0 + block)
        g = got[sl]
        fields = (q["qtype"][sl], q["v"][sl], q["l"][sl], q["r"][sl])
        _, ref_d, matches = reference.search(V, C, T, *fields, q["V"][sl], k, sn)
        in_range = (g >= 0) & (g < n)
        gi = torch.where(in_range, g, torch.zeros_like(g))
        qt, v, l, r = (f[:, None] for f in fields)
        Cg, Tg = C[gi], T[gi]
        passes = ((~((qt == 1) | (qt == 3)) | (Cg == v))
                  & (~((qt == 2) | (qt == 3)) | ((Tg >= l) & (Tg <= r)))
                  & (gi < sn) & in_range)
        n_pad = (k - matches).clamp(min=0)[:, None]
        is_pad = in_range & (g >= n - n_pad)
        bad_q = (~passes & ~is_pad).sum(dim=1)
        # each id may occur once as a passing row and once as a pad
        allowed = passes.long() + is_pad.long()
        srt, order = torch.sort(g, dim=1)
        a = torch.gather(allowed, 1, order)
        idx = torch.arange(k, device=g.device).expand_as(srt)
        new = torch.ones_like(srt, dtype=torch.bool)
        new[:, 1:] = srt[:, 1:] != srt[:, :-1]
        run = idx - torch.where(new, idx, torch.zeros_like(idx)).cummax(dim=1).values
        dup_q = ((run >= 1) & (run >= a)).sum(dim=1)
        got_d, _ = torch.sort(reference.distances64(V, gi, q["V"][sl]), dim=1)
        gap_q = (got_d - ref_d).abs().amax(dim=1)
        gap = max(gap, float(gap_q.max()))
        bad += int(bad_q.sum())
        dup += int(dup_q.sum())
        failed += int(((gap_q > lim["dist_gap"]) | (bad_q > 0) | (dup_q > 0)).sum())
    return {"dist_gap": gap, "bad_ids": bad, "dup_ids": dup, "failed": failed}
