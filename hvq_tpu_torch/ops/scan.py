"""The packed bin scan: the non-kernel half of ``hvq_tpu.ops.pallas_scan``.

Holds the bin-depth choice, the certificate's per-bin decode and
:func:`packed_scan_plain`, the plain PyTorch version of the packed-scan
kernel K1 (``fused_packed_scan_v3``). The CUDA kernel itself and its
wrapper live in :mod:`hvq_tpu_torch.ops.kernels`; on a CPU tensor that
wrapper runs this function.

The scan computes, for each 128-row bin of each ``db_tile``-row tile,

    dist = max(‖q‖² + ‖d‖² − 2·q·d, 0)        masked to +inf unless
           oid < sn ∧ (¬ac ∨ C == v) ∧ (¬at ∨ l ≤ T ≤ r)
    key  = bitcast(dist) & ~0x7F | s          (order-preserving, dist ≥ 0)

in the axis1 layout: bin b of a tile holds rows {s·bins + b : s < 128},
bins = db_tile / 128, and the payload s is the slice index. R rounds of
min over s give each bin its R best keys, written round-major inside each
tile: column = tile·R·bins + round·bins + bin. A key decodes to
``dist = key & ~0x7F`` and ``pos = tile·Dt + s·bins + bin (+ row0)``.
"""

from __future__ import annotations

import math

import torch

from hvq_tpu_torch.ops.distance import dot_nt
from hvq_tpu_torch.ops.masks import block_mask
from hvq_tpu_torch.ops.topk import BIN, INF_KEY, KEY_MASK

# Elements of the (B, rows) distance block the plain scan holds at once.
_PLAIN_CHUNK = 1 << 26


def _poisson_tail(lam: float, j: int) -> float:
    """P(X ≥ j) for X ~ Poisson(lam), summed to convergence."""
    if j <= 0:
        return 1.0
    term = math.exp(-lam) * lam ** j / math.factorial(j)
    total = 0.0
    for i in range(200):
        total += term
        term *= lam / (j + i + 1)
        if term < total * 1e-12:
            break
    return total


def choose_bin_top(
    n_pad: int, kprime: int = 128, certified: bool = False
) -> int | None:
    """Pick R, the entries kept per bin, so expected candidate loss is tiny.

    Losing a true top-k' candidate needs R+1 of the k' to share one bin;
    with bins = n/128 and X ~ Poisson(k'/bins), E[lost] ≈ bins·P(X ≥ R+1).
    ``certified=True``: the engine's certificate and rerun ladder carry
    correctness, so R only controls cost (target loss rate < 1e-4 per
    query). ``certified=False``: returns None when no reasonable R keeps
    the loss below 1e-4 (the caller then takes the streaming path).
    """
    bins = n_pad // BIN
    if bins < 1:
        return None
    lam = kprime / bins

    if certified:
        for R in (2, 3, 4, 6, 8, 10, 12, 16, 24, 32, 48, 64, 96, 128):
            if R * bins < 2 * kprime:
                continue
            if bins * _poisson_tail(lam, R + 1) < 1e-4:
                return min(R, BIN)
        return BIN if bins * BIN >= n_pad else None  # keep everything
    for R in (2, 3, 4, 8):
        if R * bins < 4 * kprime:
            continue
        if bins * _poisson_tail(lam, R + 1) < 1e-4:
            return R
    return None


def last_round_dists(out_s: torch.Tensor, nt: int, bin_top: int, bins: int):
    """Per-bin worst-kept distances (B, nt·bins) of a packed scan's output.

    The last round's columns hold each bin's R-th extracted value, the
    certificate's per-bin saturation level (+inf where a bin had fewer
    than R unmasked rows)."""
    B = out_s.shape[0]
    return out_s.view(B, nt, bin_top, bins)[:, :, -1, :].reshape(B, -1)


def scan_window(n_pad: int, db_tile: int, row0, ntw) -> tuple[int, int]:
    """(first tile, tile count) of a scan over rows [row0, row0 + ntw·Dt)."""
    if db_tile <= 0 or db_tile % BIN:
        raise ValueError(f"db_tile {db_tile} is not a multiple of {BIN}")
    if n_pad % db_tile:
        raise ValueError(f"n_pad {n_pad} not divisible by db_tile {db_tile}")
    nt = n_pad // db_tile
    if row0 is None:
        return 0, nt
    row0 = int(row0)
    if row0 % db_tile or ntw is None:
        raise ValueError("a window needs a tile-aligned row0 and ntw")
    t0 = row0 // db_tile
    if t0 < 0 or ntw < 1 or t0 + ntw > nt:
        raise ValueError(f"window tiles [{t0}, {t0 + ntw}) outside [0, {nt})")
    return t0, int(ntw)


def decode_keys(keys: torch.Tensor, db_tile: int, bin_top: int, row0=None):
    """(dist, pos) from (B, nt·R·bins) packed keys in the axis1 layout."""
    bins = db_tile // BIN
    W = keys.shape[1]
    col = torch.arange(W, dtype=torch.int32, device=keys.device)
    pos = (col // (bin_top * bins)) * db_tile + (keys & 0x7F) * bins + col % bins
    if row0 is not None:
        pos = pos + int(row0)      # window scan: GLOBAL positions
    return (keys & KEY_MASK).view(torch.float32), pos


def packed_scan_plain(
    Vs, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
    db_tile: int = 16384,
    bin_top: int = 2,
    row0=None,
    ntw: int | None = None,
):
    """Plain PyTorch version of K1 (``fused_packed_scan_v3``).

    ``Vs`` is the scan plane: fp32 runs the literal 3-pass bf16 split, a
    bf16 plane one bf16 pass (operands upcast, products exact in fp32).
    ``row0`` (tile-aligned) + ``ntw`` scan only that window of tiles and
    return global positions. Returns (dist (B, W) fp32 [low 7 bits zeroed,
    +inf = empty], pos (B, W) int32), W = nt · bin_top · db_tile/128.
    """
    n_pad = Vs.shape[0]
    t0, nt = scan_window(n_pad, db_tile, row0, ntw)
    if not 1 <= bin_top <= BIN:
        raise ValueError(f"bin_top {bin_top} outside [1, {BIN}]")
    bins = db_tile // BIN
    B = qV.shape[0]
    precision = "default" if Vs.dtype == torch.bfloat16 else "high"
    qf = qV.float()
    qnorm = (qf * qf).sum(dim=1)
    s_iota = torch.arange(BIN, dtype=torch.int32, device=Vs.device)
    s_iota = s_iota.view(1, 1, BIN, 1)
    out = torch.empty((B, nt, bin_top, bins), dtype=torch.int32,
                      device=Vs.device)
    step = max(1, _PLAIN_CHUNK // max(1, B * db_tile))
    for c0 in range(0, nt, step):
        c1 = min(nt, c0 + step)
        rows = slice((t0 + c0) * db_tile, (t0 + c1) * db_tile)
        dist = dn[rows][None, :] - 2.0 * dot_nt(qf, Vs[rows], precision)
        dist = dist + qnorm[:, None]
        # `where`, not clamp: -0.0 would pack to a negative key
        dist = torch.where(dist > 0, dist, 0.0)
        ok = block_mask(C[rows], T[rows], oid[rows], sn,
                        active_c, v, active_t, l, r)
        dist = dist.masked_fill(~ok, float("inf"))
        keys = (
            dist.view(torch.int32).view(B, c1 - c0, BIN, bins) & KEY_MASK
        ) | s_iota
        del dist, ok
        for rnd in range(bin_top):
            m = keys.amin(dim=2)                     # (B, tiles, bins)
            out[:, c0:c1, rnd, :] = m
            if rnd + 1 < bin_top:
                keys.masked_fill_(s_iota == (m & 0x7F)[:, :, None, :], INF_KEY)
        del keys
    return decode_keys(out.view(B, -1), db_tile, bin_top, row0)
