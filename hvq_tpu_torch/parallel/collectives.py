"""Cross-shard merges: the counterpart of ``hvq_tpu.parallel.collectives``.

Every shard holds a (B, k′) result tile of exactly refined distances and
global ids. The JAX engines ``all_gather`` the tiles over the "d" mesh axis
and take one exact top-k′ of the concatenation; here the tiles are copied
to the q row's merge device without blocking, concatenated in shard order
along the candidate axis, and cut once. The certificate's terms take their
minimum over the shards one term at a time, as ``lax.pmin`` over "d".
"""

from __future__ import annotations

import torch

from hvq_tpu_torch.ops.topk import smallest_k


def allgather_topk_merge(scores, ids, kprime: int, device: torch.device):
    """Merge per-shard top-k′ tiles into the global top-k′ on ``device``.

    ``scores``: one (B, k′) fp32 tile a shard, in shard order, +inf =
    empty slot; ``ids``: the matching (B, k′) int32 global ids (a shard
    with fewer candidates than k′ gives a narrower tile; fewer than k′ in
    all pad with +inf). Returns (scores (B, k′) ascending, ids (B, k′)).
    Equal scores may come back in another order than ``lax.top_k``'s (the
    lower index first): compare distances, and ids only where the
    distances are distinct."""
    flat_s = torch.cat([s.to(device, non_blocking=True) for s in scores], dim=1)
    flat_i = torch.cat([i.to(device, non_blocking=True) for i in ids], dim=1)
    short = kprime - flat_s.shape[1]
    if short > 0:       # tiny shards: fewer than k′ candidates in all
        flat_s = torch.nn.functional.pad(flat_s, (0, short), value=float("inf"))
        flat_i = torch.nn.functional.pad(flat_i, (0, short))
    top, idx = smallest_k(flat_s, kprime)
    return top, torch.gather(flat_i, 1, idx)


def min_terms(terms, device: torch.device) -> torch.Tensor:
    """The per-term minimum over shards of their certificate terms (each a
    (B, …) tensor, +inf = term absent) on ``device``: ``lax.pmin`` over
    "d", one term at a time."""
    return torch.stack([t.to(device, non_blocking=True) for t in terms]).amin(dim=0)
