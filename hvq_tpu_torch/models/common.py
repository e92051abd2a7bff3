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
from hvq_tpu_torch.ops.topk import final_topk, merge_topk

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
    """
    B = qb.qV.shape[0]
    device = Vp.device
    scores = torch.full((B, kprime), float("inf"), device=device)
    ids = torch.zeros((B, kprime), dtype=torch.int32, device=device)
    lane = torch.arange(db_tile, dtype=torch.int32, device=device)

    def merge(scores, ids, rows, pos):
        s = tile_scores(qb.qV, Vp[rows], dn[rows], precision)
        gid = pos if oid is None else oid[rows]
        ok = block_mask(C[rows], T[rows], gid, sn, qb.active_c, qb.v,
                        qb.active_t, qb.l, qb.r)
        s = s.masked_fill(~ok, float("inf"))
        return merge_topk(scores, ids, s, pos.expand(B, -1), kprime)

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
