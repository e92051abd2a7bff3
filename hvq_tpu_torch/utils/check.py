"""Agreement checks between two bin-scan outputs (kernel vs plain).

Two implementations of a scan may round a distance differently (fp32 FMA
against the 3-pass bf16 split, or another summation order), so a row whose
true distance sits near a key-quantum boundary can land one quantum apart,
and two near-tied rows of one bin can swap rounds.

:func:`scan_agreement` holds two packed-scan outputs (K1, K2, K3) to:

* the same +inf pattern (it depends only on the mask);
* distances within one key quantum each side plus the matmul slack:
  ``2⁻¹⁵·|d| + rel_mm·(‖q‖² + max‖d‖²)``;
* the same position in each column, unless the other output kept that row
  in another round of the same bin, or the row sits within tolerance of
  the bin's last kept value (a tie at the cut).

:func:`bin_scan_agreement` holds two unpacked outputs (K4) to the same
+inf pattern, scores within ``rel_mm·(‖q‖² + max‖d‖²)`` (unquantized, may
be negative), the same id rule, and equal ids on every +inf padding entry.
Both outputs are round-major inside each tile, in either bin layout.
"""

from __future__ import annotations

import torch


def _compare(val_a, id_a, val_b, id_b, tol, bin_top: int, bins: int) -> dict:
    B, W = val_a.shape
    fin_a, fin_b = torch.isfinite(val_a), torch.isfinite(val_b)
    inf_ok = bool(torch.equal(fin_a, fin_b))
    fin = fin_a & fin_b
    tol = tol.masked_fill(~fin, 1.0)
    err = (val_a - val_b).abs().masked_fill(~fin, 0.0)
    shape = (B, W // (bin_top * bins), bin_top, bins)
    ia, ib = id_a.view(shape), id_b.view(shape)
    kept_b = (ia[:, :, :, None, :] == ib[:, :, None, :, :]).any(dim=3)
    last_b = val_b.view(shape)[:, :, -1:, :]
    at_cut = (val_a.view(shape) - last_b).abs() <= tol.view(shape)
    id_ok = (ia == ib) | kept_b | at_cut | ~fin.view(shape)
    return dict(
        ok=inf_ok and bool((err <= tol).all()) and bool(id_ok.all()),
        max_abs_err=float(err.max()),
        tol_ratio=float((err / tol).max()),
        same_pos=float((id_a == id_b)[fin].float().mean()) if fin.any() else 1.0,
        n_finite=int(fin.sum()),
        inf_pattern_ok=inf_ok,
        pos_ok=bool(id_ok.all()),
    )


def scan_agreement(
    dist_a, pos_a, dist_b, pos_b, bin_top: int, bins: int,
    qnorm: torch.Tensor, dn_max: float, rel_mm: float,
) -> dict:
    """Compare packed-scan (dist, pos) pairs of shape (B, nt·bin_top·bins).

    Returns {"ok", "max_abs_err", "tol_ratio", "same_pos", "n_finite",
    "inf_pattern_ok", "pos_ok"}; ``tol_ratio`` is the largest
    |Δdist| / tolerance over finite entries.
    """
    tol = 2.0 ** -15 * dist_b.abs() + rel_mm * (qnorm[:, None] + dn_max)
    return _compare(dist_a, pos_a, dist_b, pos_b, tol, bin_top, bins)


def bin_scan_agreement(
    score_a, id_a, score_b, id_b, bin_top: int, bins: int,
    qnorm: torch.Tensor, dn_max: float, rel_mm: float,
) -> dict:
    """Compare unpacked (score, id) pairs of shape (B, nt·bin_top·bins).

    Returns the keys of :func:`scan_agreement` plus "pad_ids_ok": every
    entry that is +inf in both outputs carries the same id (the bin's
    lane-0 ``oid``)."""
    tol = (rel_mm * (qnorm[:, None] + dn_max)).expand_as(score_b)
    res = _compare(score_a, id_a, score_b, id_b, tol, bin_top, bins)
    pad = ~torch.isfinite(score_a) & ~torch.isfinite(score_b)
    res["pad_ids_ok"] = bool(torch.equal(id_a[pad], id_b[pad]))
    res["ok"] = res["ok"] and res["pad_ids_ok"]
    return res
