"""The plain reference of the contest's hybrid k-NN, in plain PyTorch.

Semantics (the contest's ``vec_query``, README.md:24-53): a query of type
0 has no predicate, type 1 asks ``C == v``, type 2 ``l ≤ T ≤ r``, type 3
both; only rows of id < ``sn`` are candidates; the answer is the k rows of
least squared L2 distance, and where fewer than k rows pass, the tail ids
n−1, n−2, … fill it up with their own distances (duplicates allowed), all
sorted ascending.

The reference imports nothing of the program and takes nothing it made:
it reads the database the benchmark generated and the queries it sent.
It runs in blocks of queries and rows, so that it fits beside nothing
else on the device once the program has been freed:

1. candidates: the ``kp`` rows of least ‖x‖² − 2·q·x per query, an fp32
   product with TF32 off (``precision="fp32"``), or with both operands
   rounded to TF32's 10 mantissa bits first (``precision="tf32"``: the
   control, one step of precision below what the configuration states);
2. the candidates' distances Σ(q − x)² in float64, and the k least of them
   with the tail pads (``precision="tf32"`` skips this step and keeps the
   k least product scores: the control answers as a TF32 search would).
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("fp32", "tf32")


@contextlib.contextmanager
def ieee_fp32():
    """fp32 products in IEEE fp32 (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to nearest (ties to even) at TF32's 10 mantissa bits."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def predicate(qtype, v, l, r, C, T):
    """(b, rows) bool: which rows pass each query's predicate."""
    has_c = ((qtype == 1) | (qtype == 3))[:, None]
    has_t = ((qtype == 2) | (qtype == 3))[:, None]
    ok_c = C[None, :] == v[:, None]
    ok_t = (T[None, :] >= l[:, None]) & (T[None, :] <= r[:, None])
    return (~has_c | ok_c) & (~has_t | ok_t)


def distances64(V: torch.Tensor, ids: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """(b, j) float64 Σ(q − x)² of rows ``ids`` (b, j) against ``Q`` (b, dim)."""
    rows = V[ids.long()].double()
    return ((rows - Q.double()[:, None, :]) ** 2).sum(dim=-1)


def search(V, C, T, qtype, v, l, r, Q, k: int, sn: int, precision: str = "fp32",
           kp: int = 128, q_block: int = 1024, row_block: int = 1 << 21):
    """The reference answer of the queries (``qtype`` (m,) int, ``v``,
    ``l``, ``r`` (m,), ``Q`` (m, dim)) over the database (``V`` (n, dim),
    ``C``, ``T`` (n,)), all tensors on one device.

    Returns (ids (m, k) int64, dists (m, k) float64 ascending, matches (m,)
    int64: the rows that pass each predicate). ``precision="tf32"``: the
    control's answer, with the distances of its k least product scores.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    n = V.shape[0]
    sn = min(int(sn), n)
    kp = max(kp, k)
    Vs = round_tf32(V) if precision == "tf32" else V
    xn = (Vs * Vs).sum(dim=1)
    out_ids, out_d, out_m = [], [], []
    with ieee_fp32():
        for q0 in range(0, Q.shape[0], q_block):
            sl = slice(q0, q0 + q_block)
            qt, qv, ql, qr, qQ = qtype[sl], v[sl], l[sl], r[sl], Q[sl]
            qs = round_tf32(qQ) if precision == "tf32" else qQ
            b = qQ.shape[0]
            best_s = torch.full((b, kp), float("inf"), device=V.device)
            best_i = torch.zeros((b, kp), dtype=torch.int64, device=V.device)
            matches = torch.zeros(b, dtype=torch.int64, device=V.device)
            for s0 in range(0, sn, row_block):
                s1 = min(sn, s0 + row_block)
                ok = predicate(qt, qv, ql, qr, C[s0:s1], T[s0:s1])
                matches += ok.sum(dim=1)
                sc = xn[s0:s1][None, :] - 2.0 * (qs @ Vs[s0:s1].T)
                sc.masked_fill_(~ok, float("inf"))
                del ok
                top, idx = torch.topk(sc, min(kp, s1 - s0), dim=1, largest=False)
                del sc
                cat_s = torch.cat([best_s, top], dim=1)
                cat_i = torch.cat([best_i, idx + s0], dim=1)
                best_s, j = torch.topk(cat_s, kp, dim=1, largest=False)
                best_i = torch.gather(cat_i, 1, j)
            valid = torch.isfinite(best_s)
            if precision == "tf32":
                d = (best_s + (qs * qs).sum(dim=1, keepdim=True)).double()
            else:
                d = distances64(V, best_i, qQ)
            d = d.masked_fill(~valid, float("inf"))
            # the tail pads: slot j < k − matches holds id n − 1 − j
            slot = torch.arange(k, device=V.device)
            pad_i = (n - 1 - slot)[None, :].expand(b, k)
            pad_d = distances64(V, pad_i, qQ).masked_fill(
                slot[None, :] >= (k - matches)[:, None], float("inf"))
            all_d = torch.cat([d, pad_d], dim=1)
            all_i = torch.cat([best_i, pad_i], dim=1)
            top_d, j = torch.topk(all_d, k, dim=1, largest=False, sorted=True)
            out_ids.append(torch.gather(all_i, 1, j))
            out_d.append(top_d)
            out_m.append(matches)
    return torch.cat(out_ids), torch.cat(out_d), torch.cat(out_m)
