"""Agreement check between two packed-scan outputs (kernel vs plain).

Two implementations of the packed scan may round a distance differently
(fp32 FMA against the 3-pass bf16 split, or another summation order), so
a row whose true distance sits near a key-quantum boundary can land one
quantum apart, and two near-tied rows of one bin can swap rounds. The
check therefore holds the outputs to:

* the same +inf pattern (it depends only on the mask);
* distances within one key quantum each side plus the matmul slack:
  ``2⁻¹⁵·|d| + rel_mm·(‖q‖² + max‖d‖²)``;
* the same position in each column, unless the other output kept that row
  in another round of the same bin, or the row sits within tolerance of
  the bin's last kept value (a tie at the cut).
"""

from __future__ import annotations

import torch


def scan_agreement(
    dist_a, pos_a, dist_b, pos_b, bin_top: int, bins: int,
    qnorm: torch.Tensor, dn_max: float, rel_mm: float,
) -> dict:
    """Compare (dist, pos) pairs of shape (B, nt·bin_top·bins).

    Returns {"ok", "max_abs_err", "tol_ratio", "same_pos", "n_finite",
    "inf_pattern_ok", "pos_ok"}; ``tol_ratio`` is the largest
    |Δdist| / tolerance over finite entries.
    """
    B, W = dist_a.shape
    fin_a, fin_b = torch.isfinite(dist_a), torch.isfinite(dist_b)
    inf_ok = bool(torch.equal(fin_a, fin_b))
    fin = fin_a & fin_b
    tol = (
        2.0 ** -15 * dist_b.abs() + rel_mm * (qnorm[:, None] + dn_max)
    ).masked_fill(~fin, 1.0)
    err = (dist_a - dist_b).abs().masked_fill(~fin, 0.0)
    shape = (B, W // (bin_top * bins), bin_top, bins)
    pa, pb = pos_a.view(shape), pos_b.view(shape)
    kept_b = (pa[:, :, :, None, :] == pb[:, :, None, :, :]).any(dim=3)
    last_b = dist_b.view(shape)[:, :, -1:, :]
    at_cut = (dist_a.view(shape) - last_b).abs() <= tol.view(shape)
    pos_ok = (pa == pb) | kept_b | at_cut | ~fin.view(shape)
    return dict(
        ok=inf_ok and bool((err <= tol).all()) and bool(pos_ok.all()),
        max_abs_err=float(err.max()),
        tol_ratio=float((err / tol).max()),
        same_pos=float((pos_a == pos_b)[fin].float().mean()) if fin.any() else 1.0,
        n_finite=int(fin.sum()),
        inf_pattern_ok=inf_ok,
        pos_ok=bool(pos_ok.all()),
    )
