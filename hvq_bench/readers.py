"""The readings the metric files share, each from a run's record.

An end-to-end record (``--trace 0``) holds ``setup_s``, ``window_s``,
``queries``, ``walls_s`` (one wall a call), ``files`` (each call's file
of the traffic's pool), ``rows``, ``chips`` (the cell's cards),
``memory_peak_bytes_by_card`` (each card's peak allocation over set-up
and window, in card order) and ``memory_peak_bytes`` (the fullest
card's). A traced record (``--trace 1``) holds ``spans`` (the
fenced part's phases: {name: {"s", "n"}}; a fence waits for every card),
``fenced_queries``, ``traced_calls``, ``traced_queries``, ``suspects``
(the ladder's suspects a traced call), ``profile`` (``trace.read_profile``
of the profiled part: ``busy_s`` the union of every card's device
intervals, ``busy_s_by_card`` each card's own union, in card order),
``unprofiled_s`` (the wall of the profiled part's calls run once more
without the profiler) and ``k1_launches``. Each reading is None where its
record holds nothing to read.
"""

from __future__ import annotations

import sys

from hvq_bench import stats


def card_bytes_per_row(rec: dict):
    """The fullest card's peak allocation over the rows one card serves
    (``rows`` ÷ ``chips``, the database split evenly over the cards)."""
    if not rec["memory_peak_bytes"]:
        return None
    return rec["memory_peak_bytes"] / (rec["rows"] / rec["chips"])


def span_us_per_query(rec: dict, name: str):
    """Fenced microseconds of phase ``name`` per query of the fenced part."""
    span = rec["spans"].get(name)
    if span is None or not rec["fenced_queries"]:
        return None
    return span["s"] * 1e6 / rec["fenced_queries"]


def suspects_per_kquery(rec: dict):
    if not rec["traced_queries"]:
        return None
    return 1000.0 * sum(rec["suspects"]) / rec["traced_queries"]


def device_idle_pct(rec: dict):
    """100 minus the device's busy time in the profiled part over the wall
    of the same calls without the profiler, which slows the host and so
    would count its own cost as idle, in percent."""
    prof = rec["profile"]
    if not prof["device_events"] or rec["unprofiled_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / rec["unprofiled_s"])


def k1_roofline_pct(rec: dict):
    """The least time of every K1 launch of the profiled part over K1's
    device time there, in percent."""
    prof, launches = rec["profile"], rec["k1_launches"]
    if not launches or prof["k1_device_s"] <= 0:
        return None
    if prof["k1_kernels"] != len(launches):
        print(f"k1_roofline_pct: {prof['k1_kernels']} K1 kernels in the profile, "
              f"{len(launches)} launches recorded: not read", file=sys.stderr)
        return None
    least = sum(stats.packed_scan_least_s(**launch) for launch in launches)
    return 100.0 * least / prof["k1_device_s"]
