"""Shared engine machinery: the counterpart of ``hvq_tpu.models.common``.

  streaming scan:  scores = ‖d‖² − 2·Q·Dᵀ + predicate mask, tile by tile,
                   carry = top-k'(carry ∪ tile)                [ops.topk]
  finalize:        exact fp32 refinement of the k' survivors,
                   reference-exact pad-to-k, ascending sort

The padding reproduces the reference (optimized.hpp:120-128): when fewer
than k candidates pass, the missing slots take ids n-1, n-2, … of the
FULL dataset (predicate ignored, duplicates allowed), and everything is
ordered by true distance (optimized_impl.h:392-437).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hvq_tpu_torch import constants as _c
from hvq_tpu_torch.ops.distance import exact_distances, tile_scores
from hvq_tpu_torch.ops.masks import block_mask
from hvq_tpu_torch.ops.scan import last_round_dists
from hvq_tpu_torch.ops.topk import BIN, final_topk, merge_topk

# Elements of the (B, rows) score block a listed-tile scan holds at once.
_STREAM_CHUNK = 1 << 26


class QueryBatch(NamedTuple):
    """Decoded query batch (B queries) on the device."""

    qV: torch.Tensor        # (B, 128) fp32, zero-padded query vectors
    active_c: torch.Tensor  # (B,) bool
    v: torch.Tensor         # (B,) fp32
    active_t: torch.Tensor  # (B,) bool
    l: torch.Tensor         # (B,) fp32
    r: torch.Tensor         # (B,) fp32


def scan_database(
    Vp: torch.Tensor,   # (n_pad, 128) fp32
    C: torch.Tensor,
    T: torch.Tensor,
    dn: torch.Tensor,
    qb: QueryBatch,
    sn: int,
    kprime: int,
    db_tile: int,
    precision: str = "highest",
    oid: torch.Tensor | None = None,
    tile_index=None,
    strategy: str = "topk",
    compute_dtype: torch.dtype = torch.float32,
):
    """Streaming masked-distance top-k' over every tile (no bin reduce).

    The certified-exact path and the last rung of the rerun ladder.
    Returns (scores (B, k'), ids (B, k') int32) with +inf marking empty
    slots; ids are row positions. ``oid`` (n_pad,): the original id of
    each row of a reordered view; the sample limit then tests
    ``oid < sn`` (the reference's file order), and the returned ids stay
    view positions for a local refinement gather (``finalize(oid=)``).

    ``tile_index`` (a host sequence of tile numbers): scan only the listed
    tiles (the IVF engine's probed buckets); an entry of -1 marks a
    padding slot, a tile masked to +inf, so it contributes nothing. The
    listed tiles are scored ``_STREAM_CHUNK`` elements at a time, one
    top-k′ merge per chunk: the same candidate set as a merge per tile, up
    to which of two equal scores survives the cut.

    ``strategy``: the merge of ``ops.topk.merge_topk`` (``"binned"``
    reduces each 128-column group of a tile, or of a chunk, to its best
    entry first: approximate). ``compute_dtype``: the query and the rows
    are cast to it before the product (``torch.bfloat16``: the products
    of the rounded values, exact in fp32, as the JAX ``compute_dtype``).
    """
    B = qb.qV.shape[0]
    device = Vp.device
    qV = qb.qV.to(compute_dtype)
    scores = torch.full((B, kprime), float("inf"), device=device)
    ids = torch.zeros((B, kprime), dtype=torch.int32, device=device)
    lane = torch.arange(db_tile, dtype=torch.int32, device=device)

    def merge(scores, ids, rows, pos):
        s = tile_scores(qV, Vp[rows].to(compute_dtype), dn[rows], precision)
        gid = pos if oid is None else oid[rows]
        ok = block_mask(C[rows], T[rows], gid, sn, qb.active_c, qb.v,
                        qb.active_t, qb.l, qb.r)
        s = s.masked_fill(~ok, float("inf"))
        return merge_topk(scores, ids, s, pos.expand(B, -1), kprime, strategy)

    if tile_index is None:
        for base in range(0, Vp.shape[0], db_tile):
            scores, ids = merge(scores, ids, slice(base, base + db_tile), lane + base)
        return scores, ids
    tiles = np.asarray(tile_index, np.int64)
    tiles = torch.from_numpy(tiles[tiles >= 0]).to(device)
    step = max(1, _STREAM_CHUNK // max(1, B * db_tile))
    for c in range(0, tiles.numel(), step):
        pos = (tiles[c : c + step, None].to(torch.int32) * db_tile + lane).reshape(-1)
        scores, ids = merge(scores, ids, pos.long(), pos)
    return scores, ids


def finalize(
    cand_scores: torch.Tensor,  # (B, k') selection scores, +inf = empty
    cand_ids: torch.Tensor,     # (B, k') int32 row positions
    Vp: torch.Tensor,           # (n_pad, 128) fp32 vectors
    qb: QueryBatch,
    n: int,                     # true dataset size
    k: int,
    tail_V: torch.Tensor,       # (t, 128) tail rows: tail_V[j] = V[n-1-j]
    oid: torch.Tensor | None = None,   # (n_pad,) original ids of view rows
):
    """Exact refinement + reference padding + final ascending sort.

    Returns (ids (B, k) int32, dists (B, k) fp32), dists being the direct
    fp32 Σ(q−d)² that the .dist file recomputes (io.h:38-48). With
    ``oid`` this is the JAX ``finalize_view`` for reordered views:
    ``cand_ids`` are view positions, refined by gathering view rows, and
    the survivors map to their original ids before the tail padding.
    """
    valid = torch.isfinite(cand_scores)
    rows = Vp[cand_ids.long()]                           # (B, k', 128)
    exact = exact_distances(qb.qV, rows).masked_fill(~valid, float("inf"))
    sel_d, sel_ids = final_topk(exact, cand_ids, k)
    if oid is not None:
        sel_ids = oid[sel_ids.long()]
    return finalize_with_tail(sel_d, sel_ids, tail_V, qb, n, k)


def finalize_with_tail(
    exact_scores: torch.Tensor,  # (B, ≥k) EXACT distances ascending, +inf empty
    cand_ids: torch.Tensor,      # (B, ≥k) int32 ids
    tail_V: torch.Tensor,        # (t, 128) tail rows: tail_V[j] = V[n-1-j]
    qb: QueryBatch,
    n: int,
    k: int,
):
    """Pad the empty slots with tail ids priced from ``tail_V``, then sort
    ascending by distance (stable, as ``jnp.argsort``)."""
    sel_d = exact_scores[:, :k]
    sel_ids = cand_ids[:, :k]
    valid = torch.isfinite(sel_d)
    m = valid.sum(dim=1, keepdim=True)
    slot = torch.arange(k, device=sel_d.device)[None, :]
    pad_ids = (n - 1 - (slot - m)).to(torch.int32)
    pad_pos = (slot - m).clamp(0, tail_V.shape[0] - 1)
    pad_d = exact_distances(qb.qV, tail_V[pad_pos])
    final_ids = torch.where(valid, sel_ids, pad_ids)
    final_d = torch.where(valid, sel_d, pad_d)
    final_d, order = torch.sort(final_d, dim=1, stable=True)
    return torch.gather(final_ids, 1, order), final_d


def repair_thr_pre(scores, k: int, qV, dn_max: float, rel_mm: float,
                   rel_t: float, abs_: float):
    """Provisional saturation threshold (B,) for the repair's gather gate
    (``hvq_tpu.models.common.repair_thr_pre``): the k-th candidate
    ESTIMATE plus DOUBLED slack. The k-th exact distance can only be
    smaller than estimate + slack, so thr_pre ≥ the final certificate
    threshold and gating a bin off at sel_v ≥ thr_pre is sound. +inf
    (repair every selected bin) when fewer than k candidates are kept.
    One definition for every engine."""
    if k > scores.shape[1]:
        return torch.full(scores.shape[:1], float("inf"), device=scores.device)
    qf = qV.float()
    qn = (qf * qf).sum(dim=1)
    t_pre = scores[:, k - 1]
    return t_pre + 2.0 * (rel_mm * (qn + dn_max) + rel_t * t_pre + abs_)


def cert_suspect(t_bin, t_l2, t_kc, debug: bool):
    """The certificate's suspect column from its per-term flags (bool
    (B,) each, None = term absent). ``debug`` (``HVQ_CERT_TERMS=1``
    forensics): an int32 bitmask, 1 = bin (after a repair: the residual
    bin), 2 = level 2, 4 = k′ cut; nonzero still reads as suspect.
    Otherwise a plain bool OR."""
    terms = [(t, w) for t, w in ((t_bin, 1), (t_l2, 2), (t_kc, 4)) if t is not None]
    if debug:
        return sum(t.to(torch.int32) * w for t, w in terms)
    out = terms[0][0]
    for t, _ in terms[1:]:
        out = out | t
    return out


def bin_repair_candidates(
    out_s: torch.Tensor,        # (B, W) packed-scan distances (quantized)
    cand_scores: torch.Tensor,  # (B, k') selected estimates, +inf = empty
    cand_pos: torch.Tensor,     # (B, k') their positions (int32)
    nt: int,
    bin_top: int,
    bins: int,
    db_tile: int,
    layout: str,
    C: torch.Tensor,
    T: torch.Tensor,
    oid: torch.Tensor,
    qb: QueryBatch,
    sn: int,
    rb: int,
    row0: int | None = None,
    id_offset: int | None = None,
    thr_pre: torch.Tensor | None = None,
):
    """In-program repair of the certificate's bin term
    (``hvq_tpu.models.common.bin_repair_candidates``).

    The ``rb`` most-saturated bins (the smallest per-bin R-th kept values
    of ``last_round_dists``, by iterated argmin) give up all 128 of their
    rows as extra refine candidates, so the bin term becomes
    ``remaining_min < thr``: the (rb+1)-th most-saturated bin still under
    the threshold. The selection is threshold-free. A bin's rows decode
    as the scan that produced ``out_s`` laid them out: axis1 ``tile·Dt +
    s·bins + bin``, lane ``tile·Dt + bin·128 + s``; ``nt`` is the tiles
    the scan covered (a window's own count).

    The rows are masked as the scan masks them: ``oid[pos] < sn`` (the
    ORIGINAL id), category and time. All-+inf bins (fewer saturated bins
    than ``rb``) are masked, and rows already among the candidates are
    dropped, so the refined top-k never holds a row twice; the compare
    runs in the space the candidates carry. ``row0``: a window's offset,
    applied BEFORE the attribute gathers (``C``, ``T``, ``oid`` are the
    whole view's). ``id_offset``: applied only to the RETURNED positions
    and the dedup (shard-local gathers, global candidate ids).
    ``thr_pre`` (B,): a provisional threshold ≥ the final one
    (:func:`repair_thr_pre`); a selected bin at or above it is gated to
    row 0, masked.

    Returns (scores', pos', remaining_min (B,)): the repair rows appended
    with score 0 (refine me) or +inf.
    """
    B = out_s.shape[0]
    work = last_round_dists(out_s, nt, bin_top, bins)        # (B, nbins)
    sel_b, sel_v = [], []
    for _ in range(rb):
        v, bi = work.min(dim=1)
        sel_v.append(v)
        sel_b.append(bi)
        work = work.scatter(1, bi[:, None], float("inf"))
    remaining_min = work.amin(dim=1)
    del work
    sel_b = torch.stack(sel_b, dim=1)                        # (B, rb) int64
    sel_v = torch.stack(sel_v, dim=1)                        # (B, rb)
    tile, b = sel_b // bins, sel_b % bins
    s_iota = torch.arange(BIN, device=out_s.device)
    if layout == "axis1":
        pos = tile[:, :, None] * db_tile + s_iota * bins + b[:, :, None]
    else:
        pos = tile[:, :, None] * db_tile + b[:, :, None] * BIN + s_iota
    if row0 is not None:
        pos = pos + int(row0)                                # window: global
    bin_live = torch.isfinite(sel_v)
    if thr_pre is not None:
        bin_live &= sel_v < thr_pre[:, None]
        pos = torch.where(bin_live[:, :, None], pos, 0)
    pos = pos.reshape(B, rb * BIN)
    ok = bin_live[:, :, None].expand(B, rb, BIN).reshape(B, rb * BIN)
    ok = ok & (oid[pos] < sn)
    ok &= (~qb.active_c[:, None]) | (C[pos] == qb.v[:, None])
    Tg = T[pos]
    ok &= (~qb.active_t[:, None]) | ((Tg >= qb.l[:, None]) & (Tg <= qb.r[:, None]))
    out_pos = (pos if id_offset is None else pos + int(id_offset)).to(torch.int32)
    dup = ((out_pos[:, :, None] == cand_pos[:, None, :])
           & torch.isfinite(cand_scores)[:, None, :]).any(dim=2)
    rep = torch.where(ok & ~dup, 0.0, float("inf"))
    return (torch.cat([cand_scores, rep], dim=1),
            torch.cat([cand_pos.to(torch.int32), out_pos], dim=1),
            remaining_min)


def tail_block_np(V: np.ndarray, t: int = 128) -> np.ndarray:
    """Host-side (t, 128) tail block: row j holds V[n-1-j], zero-padded."""
    t = min(t, V.shape[0])
    out = np.zeros((t, _c.PADDED_DIM), np.float32)
    out[:, : V.shape[1]] = V[V.shape[0] - t:][::-1]
    return out


def pad_query_arrays(qs, batch: int):
    """Host-side: pad query arrays to a multiple of the query batch size.

    Padding queries are type-0 zero-vectors; their results are sliced away.
    """
    m = qs.m
    m_pad = -(-m // batch) * batch
    if m_pad == m:
        return qs.V, qs.qtype, qs.v, qs.l, qs.r, m_pad
    extra = m_pad - m
    V = np.concatenate([qs.V, np.zeros((extra, qs.V.shape[1]), np.float32)])
    qtype = np.concatenate([qs.qtype, np.zeros(extra, np.int32)])
    v = np.concatenate([qs.v, np.full(extra, -1.0, np.float32)])
    l = np.concatenate([qs.l, np.full(extra, -1.0, np.float32)])
    r = np.concatenate([qs.r, np.full(extra, -1.0, np.float32)])
    return V, qtype, v, l, r, m_pad
