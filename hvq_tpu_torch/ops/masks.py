"""Predicate masks: the PyTorch counterpart of ``hvq_tpu.ops.masks``.

Every query type is served by one formula over a (B, Dt) block,

    ok = (id < sn) & (no_C_constraint | C == v) & (no_T_constraint | l<=T<=r)

and masked rows get distance +inf (reference optimized.hpp:84-117).
"""

from __future__ import annotations

import numpy as np
import torch


def query_predicate_fields(qtype, v, l, r):
    """Decode per-query predicate activation from the query-type field.

    Types: 0 = none, 1 = C==v, 2 = l<=T<=r, 3 = both. Returns
    (active_c, v, active_t, l, r) with bool activations.
    """
    qtype = torch.as_tensor(qtype)
    active_c = (qtype == 1) | (qtype == 3)
    active_t = (qtype == 2) | (qtype == 3)
    return (
        active_c, torch.as_tensor(v), active_t, torch.as_tensor(l),
        torch.as_tensor(r),
    )


def block_mask(C_tile, T_tile, gid_tile, sn, active_c, v, active_t, l, r):
    """(B, Dt) bool mask: which rows of this tile pass each query.

    ``gid_tile < sn`` is the sample-proportion scan limit and also masks the
    alignment padding rows past the dataset end. C equality is exact float
    comparison, as in the reference (C is discretized by contract).
    """
    in_range = gid_tile[None, :] < sn
    c_ok = (~active_c[:, None]) | (C_tile[None, :] == v[:, None])
    t_ok = (~active_t[:, None]) | (
        (T_tile[None, :] >= l[:, None]) & (T_tile[None, :] <= r[:, None])
    )
    return in_range & c_ok & t_ok


def predicate_selectivity(mask) -> float:
    """Fraction of candidates passing (a NumPy array or a tensor): a
    diagnostic for the index layer's routing."""
    mask = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
    return float(mask.mean()) if mask.size else 0.0
