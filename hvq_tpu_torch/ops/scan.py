"""The packed bin scan: the non-kernel half of ``hvq_tpu.ops.pallas_scan``.

Holds the bin-depth choices, the certificate's per-bin decode and the
plain PyTorch versions of the four scan kernels: :func:`packed_scan_plain`
for the packed scans K1 (``fused_packed_scan_v3``, axis1 layout), K3
(``fused_packed_scan``, lane layout, fp32) and K2 (``fused_packed_scan_v2``,
lane layout, 3-pass bf16 split), and :func:`bin_scan_plain` for the
unpacked K4 (``fused_bin_scan``). :func:`deferred_bin_scan` is K4's XLA
sibling ``deferred_bin_scan_xla`` (no kernel on either side): the engines'
``scan_impl="xla_deferred"``. The CUDA kernels and their wrappers live
in :mod:`hvq_tpu_torch.ops.kernels`; on a CPU tensor a wrapper runs the
function here.

The packed scans compute, for each 128-row bin of each ``db_tile``-row
tile,

    dist = max(‖q‖² + ‖d‖² − 2·q·d, 0)        masked to +inf unless
           oid < sn ∧ (¬ac ∨ C == v) ∧ (¬at ∨ l ≤ T ≤ r)
    key  = bitcast(dist) & ~0x7F | s          (order-preserving, dist ≥ 0)

where bin b of a tile holds rows {s·bins + b : s < 128} in the axis1
layout (bins = db_tile / 128) and rows {b·128 + s : s < 128} in the lane
layout; the payload s is the slice (axis1) or the lane. R rounds of min
over s give each bin its R best keys, written round-major inside each
tile: column = tile·R·bins + round·bins + bin. A key decodes to
``dist = key & ~0x7F`` and ``pos = tile·Dt + s·bins + bin`` (axis1) or
``tile·Dt + bin·128 + s`` (lane), ``+ row0`` for a window.
"""

from __future__ import annotations

import math

import torch

from hvq_tpu_torch.ops.distance import PRECISIONS, dot_nt
from hvq_tpu_torch.ops.masks import block_mask
from hvq_tpu_torch.ops.topk import BIN, INF_KEY, KEY_MASK

# Elements of the (B, rows) distance block the plain scan holds at once.
_PLAIN_CHUNK = 1 << 26

# How a tile's rows group into 128-row bins (see the module docstring).
LAYOUTS = ("axis1", "lane")


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


def kernel_bin_top(
    db_tile: int, n_pad: int, kprime: int = 128, certified: bool = False
) -> int | None:
    """bin_top for the lane-layout kernels K2/K3, as the JAX package picks
    it: at least the Poisson-sound R (:func:`choose_bin_top`), rounded up
    so the per-tile output width ``R * db_tile/BIN`` is a multiple of 128
    (a TPU output-block rule; kept so R, and hence every output column,
    equals the JAX engine's)."""
    R0 = choose_bin_top(n_pad, kprime, certified=certified)
    if R0 is None:
        return None
    bins = db_tile // BIN
    R = R0
    while (R * bins) % 128:
        R += 1
    return R


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


def check_bin_top(bin_top: int) -> None:
    if not 1 <= bin_top <= BIN:
        raise ValueError(f"bin_top {bin_top} outside [1, {BIN}]")


def decode_keys(keys: torch.Tensor, db_tile: int, bin_top: int, row0=None,
                layout: str = "axis1"):
    """(dist, pos) from (B, nt·R·bins) packed keys in ``layout``."""
    bins = db_tile // BIN
    W = keys.shape[1]
    col = torch.arange(W, dtype=torch.int32, device=keys.device)
    payload, b = keys & 0x7F, col % bins
    in_tile = payload * bins + b if layout == "axis1" else b * BIN + payload
    pos = (col // (bin_top * bins)) * db_tile + in_tile
    if row0 is not None:
        pos = pos + int(row0)      # window scan: GLOBAL positions
    return (keys & KEY_MASK).view(torch.float32), pos


def packed_scan_plain(
    Vs, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
    db_tile: int = 16384,
    bin_top: int = 2,
    row0=None,
    ntw: int | None = None,
    layout: str = "axis1",
    precision: str | None = None,
    masked: bool = True,
):
    """Plain PyTorch version of the packed scans K1, K3 and K2.

    ``Vs`` is the scan plane. ``precision`` (a name of
    :mod:`hvq_tpu_torch.ops.distance`) defaults to K1's: the literal 3-pass
    bf16 split on an fp32 plane, one bf16 pass on a bf16 plane (operands
    upcast, products exact in fp32). K3 (``fused_packed_scan``) is
    ``layout="lane", precision="highest"``, K2 (``fused_packed_scan_v2``)
    ``layout="lane", precision="high"``, both on the fp32 plane; the lane
    layout with the default precision is the JAX
    ``deferred_packed_scan_xla(layout="lane")``. ``row0`` (tile-aligned) +
    ``ntw`` scan only that window of tiles and return global positions.
    ``masked=False`` drops the predicate and sample mask (the JAX
    ``deferred_packed_scan_xla(masked=False)``, for batches of type-0
    queries at sample proportion 1): every row, padding rows included,
    keeps its distance. Returns (dist (B, W) fp32 [low 7 bits zeroed,
    +inf = empty], pos (B, W) int32), W = nt · bin_top · db_tile/128.
    """
    n_pad = Vs.shape[0]
    t0, nt = scan_window(n_pad, db_tile, row0, ntw)
    check_bin_top(bin_top)
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
    if precision is None:
        precision = "default" if Vs.dtype == torch.bfloat16 else "high"
    elif precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")
    bins = db_tile // BIN
    B = qV.shape[0]
    qf = qV.float()
    qnorm = (qf * qf).sum(dim=1)
    # the axis of a bin's 128 members in the (B, tiles, ·, ·) key block
    red = 2 if layout == "axis1" else 3
    s_iota = torch.arange(BIN, dtype=torch.int32, device=Vs.device)
    s_iota = s_iota.view((1, 1, BIN, 1) if red == 2 else (1, 1, 1, BIN))
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
        if masked:
            ok = block_mask(C[rows], T[rows], oid[rows], sn,
                            active_c, v, active_t, l, r)
            dist = dist.masked_fill(~ok, float("inf"))
            del ok
        shape = (B, c1 - c0, BIN, bins) if red == 2 else (B, c1 - c0, bins, BIN)
        keys = (dist.view(torch.int32).view(shape) & KEY_MASK) | s_iota
        del dist
        for rnd in range(bin_top):
            m = keys.amin(dim=red)                   # (B, tiles, bins)
            out[:, c0:c1, rnd, :] = m
            if rnd + 1 < bin_top:
                keys.masked_fill_(s_iota == (m & 0x7F).unsqueeze(red), INF_KEY)
        del keys
    return decode_keys(out.view(B, -1), db_tile, bin_top, row0, layout)


def bin_scan_plain(
    Vp, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
    db_tile: int = 2048,
    bin_top: int = 2,
):
    """Plain PyTorch version of K4 (``fused_bin_scan``), the port of
    ``fused_bin_scan_reference``.

    Unpacked, lane layout: ``score = ‖d‖² − 2·q·d`` at fp32 (no ‖q‖², no
    clamp, so scores may be negative), +inf where masked (the sample test
    reads ``oid``). Each 128-lane bin gives R rounds of argmin/min; ties go
    to the lowest lane (argmin's first occurrence), and a bin with fewer
    than R unmasked rows pads with (+inf, ``oid`` of its lane 0), which is
    what argmin over an all-+inf bin returns. Returns (scores (B, W) fp32,
    ids (B, W) int32 = ``oid[row]``), round-major in each tile as K1.
    """
    return _unpacked_bin_scan(Vp, C, T, dn, oid, qV, active_c, v, active_t,
                              l, r, sn, db_tile, bin_top, "highest",
                              full_distance=False, payload=oid)


def deferred_bin_scan(
    Vp, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
    db_tile: int = 8192,
    bin_top: int = 2,
    precision: str = "highest",
    payload=None,
):
    """The JAX ``deferred_bin_scan_xla``: K4's unpacked per-bin argmin
    rounds (lane layout) on the FULL squared distance, ``‖q‖² + ‖d‖² −
    2·q·d`` clamped at 0, as the packed scans compute it, so the
    level-2 reduce and the certificate read its output like theirs. The
    sample limit tests ``oid``; ``payload`` (default ``oid``) is what each
    kept entry reports (a sorted view passes its positions). Columns are
    tile-major, then round, then bin (``pallas_scan.py:305-312``), which
    ``last_round_dists`` decodes. Returns (dist (B, W) fp32, +inf = empty,
    payload (B, W) int32), W = nt · bin_top · db_tile/128.
    """
    return _unpacked_bin_scan(Vp, C, T, dn, oid, qV, active_c, v, active_t,
                              l, r, sn, db_tile, bin_top, precision,
                              full_distance=True,
                              payload=oid if payload is None else payload)


def _unpacked_bin_scan(Vp, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
                       db_tile: int, bin_top: int, precision: str,
                       full_distance: bool, payload):
    """R rounds of argmin/min over each contiguous 128-row bin of each
    tile (K4 and ``deferred_bin_scan``); ``full_distance`` adds ‖q‖² and
    clamps at 0."""
    n_pad = Vp.shape[0]
    _, nt = scan_window(n_pad, db_tile, None, None)
    check_bin_top(bin_top)
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")
    bins = db_tile // BIN
    B = qV.shape[0]
    qf = qV.float()
    qnorm = (qf * qf).sum(dim=1)[:, None]
    lane = torch.arange(BIN, device=Vp.device).view(1, 1, 1, BIN)
    out_s = torch.empty((B, nt, bin_top, bins), dtype=torch.float32,
                        device=Vp.device)
    out_i = torch.empty((B, nt, bin_top, bins), dtype=torch.int32,
                        device=Vp.device)
    step = max(1, _PLAIN_CHUNK // max(1, B * db_tile))
    for c0 in range(0, nt, step):
        c1 = min(nt, c0 + step)
        rows = slice(c0 * db_tile, c1 * db_tile)
        s = dn[rows][None, :] - 2.0 * dot_nt(qf, Vp[rows], precision)
        if full_distance:
            s = (s + qnorm).clamp_min_(0.0)
        ok = block_mask(C[rows], T[rows], oid[rows], sn,
                        active_c, v, active_t, l, r)
        s = s.masked_fill(~ok, float("inf")).view(B, c1 - c0, bins, BIN)
        g = payload[rows].to(torch.int32).view(1, c1 - c0, bins, BIN)
        g = g.expand(B, -1, -1, -1)
        del ok
        for rnd in range(bin_top):
            a = s.argmin(dim=3, keepdim=True)        # first occurrence
            out_s[:, c0:c1, rnd, :] = s.gather(3, a)[..., 0]
            out_i[:, c0:c1, rnd, :] = g.gather(3, a)[..., 0]
            if rnd + 1 < bin_top:
                s.masked_fill_(lane == a, float("inf"))
        del s
    return out_s.view(B, -1), out_i.view(B, -1)
