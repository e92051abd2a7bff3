"""Top-k primitives: the PyTorch counterpart of ``hvq_tpu.ops.topk``.

Smaller distance = better throughout; +inf marks empty or masked slots.
``torch.topk`` does not promise JAX's stable tie order (``lax.top_k`` keeps
the lower index first); callers compare distances, never raw ids, so only
which of two EQUAL scores survives a cut can differ.
"""

from __future__ import annotations

import torch

BIN = 128
INF_KEY = 0x7F800000   # bit pattern of +inf with payload 0
KEY_MASK = ~0x7F       # clears the 7 payload bits of a packed key


def smallest_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k smallest entries per row, ascending."""
    return torch.topk(x, k, dim=1, largest=False, sorted=True)


TOPK_STRATEGIES = ("topk", "sort", "binned")


def merge_topk(
    carry_scores: torch.Tensor,  # (B, k') +inf = empty
    carry_ids: torch.Tensor,     # (B, k') int32
    tile_scores: torch.Tensor,   # (B, Dt)
    tile_ids: torch.Tensor,      # (B, Dt) int32
    kprime: int,
    strategy: str = "topk",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One streaming-scan step: best k' of carry ∪ tile per query row.

    ``strategy`` (``hvq_tpu.ops.topk.merge_topk``): ``"topk"`` one top-k
    over the concatenation; ``"sort"`` a full stable sort, first k'
    (``jnp.argsort`` is stable too); ``"binned"`` first keeps only the
    best entry of each 128-column group of the tile
    (:func:`bin_reduce_min`), then the top-k: it loses a neighbour when
    two of the true top-k' share a group, so it is approximate.
    """
    if strategy == "binned":
        tile_scores, tile_ids = bin_reduce_min(tile_scores, tile_ids)
    elif strategy not in TOPK_STRATEGIES:
        raise ValueError(f"unknown topk strategy {strategy!r}; one of {TOPK_STRATEGIES}")
    scores = torch.cat([carry_scores, tile_scores], dim=1)
    ids = torch.cat([carry_ids, tile_ids], dim=1)
    if strategy == "sort":
        top, idx = torch.sort(scores, dim=1, stable=True)
        top, idx = top[:, :kprime], idx[:, :kprime]
    else:
        top, idx = smallest_k(scores, kprime)
    return top, torch.gather(ids, 1, idx)


def bin_reduce_min(
    scores: torch.Tensor,  # (B, Dt), Dt % bin_size == 0
    ids: torch.Tensor,     # (B, Dt)
    bin_size: int = BIN,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The best (score, id) of every ``bin_size`` consecutive columns:
    (B, Dt / bin_size) each, ties to the lowest column (``jnp.argmin``'s
    first occurrence)."""
    B, Dt = scores.shape
    if Dt % bin_size:
        raise ValueError(f"tile width {Dt} not divisible by bin {bin_size}")
    s = scores.reshape(B, Dt // bin_size, bin_size)
    arg = s.argmin(dim=2, keepdim=True)
    return (s.gather(2, arg)[..., 0],
            ids.reshape(B, Dt // bin_size, bin_size).gather(2, arg)[..., 0])


def final_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Exact top-k with ids, ascending by score."""
    top, idx = smallest_k(scores, k)
    return top, torch.gather(ids, 1, idx)


def binned_stream_topk(
    out_s: torch.Tensor,  # (B, W) candidate stream, non-negative, +inf empty
    out_i: torch.Tensor,  # (B, W) candidate positions
    kp: int,
    rounds: int = 8,
    nt: int | None = None,
    layout: str = "axis1",
):
    """Level-2 packed bin reduce before the final candidate top-k.

    ``hvq_tpu.ops.topk.binned_stream_topk``: the stream is cut into 128-
    column bins, each reduced to its best ``rounds`` packed keys, then one
    top-k over the reduced stream. ``layout="axis1"`` (the default): bins
    are the strided column groups {b, b+bins2, …}. ``layout="lane"``:
    contiguous 128-column bins; ``nt`` (the tile count) first transposes
    the stream to (bin-slot, tile) order so a bin samples across tiles.
    Returns (scores (B, kp), ids (B, kp), worst2 (B,)), where worst2 is
    the min over bins of the ``rounds``-th kept value (+inf where no bin
    saturated) and feeds the exactness certificate.
    """
    B, W = out_s.shape
    if layout != "axis1" and nt is not None and nt > 1 and W % nt == 0:
        rb = W // nt
        out_s = out_s.view(B, nt, rb).transpose(1, 2).reshape(B, W)
        out_i = out_i.view(B, nt, rb).transpose(1, 2).reshape(B, W)
    Wp = -(-W // BIN) * BIN
    if Wp != W:
        out_s = torch.nn.functional.pad(out_s, (0, Wp - W), value=float("inf"))
    bins2 = Wp // BIN
    # the reduced stream must still be able to hold kp candidates
    rounds = min(max(rounds, -(-kp // bins2)), BIN)
    red = 1 if layout == "axis1" else 2
    lane = torch.arange(BIN, dtype=torch.int32, device=out_s.device)
    lane = lane.view((1, BIN, 1) if red == 1 else (1, 1, BIN))
    shape = (B, BIN, bins2) if red == 1 else (B, bins2, BIN)
    packed = (
        out_s.contiguous().view(torch.int32).view(shape) & KEY_MASK
    ) | lane
    outs = []
    for rnd in range(rounds):
        m = packed.amin(dim=red)                     # (B, bins2)
        outs.append(m)
        if rnd + 1 < rounds:
            packed.masked_fill_(lane == (m & 0x7F).unsqueeze(red), INF_KEY)
    del packed
    keys = torch.stack(outs, dim=1)                  # (B, rounds, bins2)
    worst2 = (keys[:, -1, :] & KEY_MASK).view(torch.float32).amin(dim=1)
    colb = torch.arange(bins2, dtype=torch.int32, device=out_s.device)
    if red == 1:
        col = (keys & 0x7F) * bins2 + colb           # strided groups
    else:
        col = colb * BIN + (keys & 0x7F)             # contiguous bins
    col = col.reshape(B, rounds * bins2)
    d2 = (keys & KEY_MASK).view(torch.float32).reshape(B, rounds * bins2)
    kp = min(kp, rounds * bins2)
    top, idx = smallest_k(d2, kp)
    sel_col = torch.gather(col, 1, idx)
    # padding columns carry +inf scores and clip safely into [0, W)
    gids = torch.gather(out_i, 1, sel_col.clamp(max=W - 1).long())
    return top, gids, worst2
