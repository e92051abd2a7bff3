"""The arithmetic the readers and the command share: rates, percentiles,
the union of device intervals and a kernel's least time. Plain Python, so
the tests can hold each to a hand-computed value."""

from __future__ import annotations

# NVIDIA H100 SXM data-sheet peaks at 700 W (dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
VEC_DIM = 100       # the contest's vector width: the lanes that carry data


def rate(work: float, seconds: float) -> float:
    """Work done per second of a window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values, p: float) -> float:
    """The ``p`` quantile of ``values`` at the sorted index ``int(p·(n−1))``
    (the port's latency tool's rule)."""
    w = sorted(values)
    if not w:
        raise ValueError("no values")
    return float(w[int(p * (len(w) - 1))])


def busy_union(intervals, lo: float, hi: float):
    """(busy, gaps) of device ``intervals`` [(start, end)] clipped to the
    window [lo, hi]: busy is the length of their union, gaps the idle
    intervals [(start, end)] between them, the window's head and tail
    included."""
    busy, gaps, end = 0.0, [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


def busy_by_card(intervals, lo: float, hi: float, cards) -> list:
    """Each card's busy length in the window [lo, hi]: the union of the
    ``intervals`` [(start, end, card)] on card ``c``, for each ``c`` of
    ``cards`` in order. Each is at most the union over all cards, and
    together they are at least that union: they add up to it only where
    no two cards were busy at once."""
    return [busy_union([(a, b) for a, b, card in intervals if card == c], lo, hi)[0]
            for c in cards]


def packed_scan_bytes(B: int, rows: int, W: int, plane_bytes: int) -> int:
    """Bytes a packed bin scan must move: each scanned row's 100 data lanes
    of ``plane_bytes`` (not the zero lanes a plane pads its rows with) and
    its C, T, ‖d‖² and original id (4 bytes each), the queries' 100 fp32
    lanes and their fields (‖q‖², two flags, v, l, r) read once, and the
    (B, W) fp32 keys and int32 positions written once."""
    return (rows * (VEC_DIM * plane_bytes + 16) + B * (VEC_DIM * 4 + 24)
            + B * W * 8)


def packed_scan_ops(B: int, rows: int) -> float:
    """Operations a packed bin scan must do: one product of 2·B·rows·100,
    whatever number of bf16 passes the kernel forms it in."""
    return 2.0 * B * rows * VEC_DIM


def packed_scan_least_s(B: int, rows: int, W: int, plane_bytes: int) -> float:
    """The least time the card could take for one packed scan: the larger
    of its operations at the bf16 peak and its bytes at the HBM rate."""
    return max(packed_scan_ops(B, rows) / PEAK_BF16_FLOPS,
               packed_scan_bytes(B, rows, W, plane_bytes) / PEAK_HBM_BYTES)
