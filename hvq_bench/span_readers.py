"""Readings of the spans the program opens at its own boundaries: the
routed packer's ``routed/pack`` (around ``_pack_groups`` and each
``_routed_layout`` of ``models.partitioned``) and the request span
``search``, which reach a run's record through the ``phases=`` hook like
every other phase, beside the select's ``batch/select`` and K1's launch
shapes. Each reading is None where its record holds nothing to read: a
program without the ``routed/pack`` span reads None for the two that
need it, and a run without a card for the two that need its times.

The traced record's parts (``readers.py``): the profiled calls (named
phases), the same calls again unprofiled, then the fenced calls
(``spans``, ``fenced_queries``). ``traced_queries`` counts all three, so
the profiled calls' queries are (``traced_queries`` −
``fenced_queries``) / 2.
"""

from __future__ import annotations

from hvq_bench import readers, stats

# the host's routing: the predicate ranges and plan, then the packer
ROUTING = ("search/route", "routed/pack")


def routed_pack_us_per_query(rec: dict):
    """Fenced microseconds of the routed packer per query of the fenced
    part. The packer enqueues no device work, so its fence leaves its host
    time alone."""
    return readers.span_us_per_query(rec, "routed/pack")


def select_least_s(launches) -> float:
    """The select's least time over the K1 launches it follows: one read
    of each launch's (B, W) fp32 scores at the HBM rate."""
    return sum(4 * launch["B"] * launch["W"] for launch in launches) / stats.PEAK_HBM_BYTES


def select_fenced_roofline_pct(rec: dict):
    """The select's least time per query of the profiled calls (every K1
    launch there, the ladder's rung-1 runs too) over its fenced
    ``batch/select`` time per query of the fenced calls, in percent. The
    two sides come from different calls of the same pool, each taken per
    query of its own; the fenced time also holds the host's enqueue of the
    select, which the device waits for after the fence, and which an
    event-timed select would overlap (``PERF.md`` §7)."""
    prof, launches = rec["profile"], rec["k1_launches"]
    select = rec["spans"].get("batch/select")
    profiled = (rec["traced_queries"] - rec["fenced_queries"]) / 2
    if (not prof["device_events"] or not launches or select is None or select["s"] <= 0
            or profiled <= 0 or not rec["fenced_queries"]):
        return None
    least_per_query = select_least_s(launches) / profiled
    return 100.0 * least_per_query / (select["s"] / rec["fenced_queries"])


def idle_routing_pct(rec: dict):
    """The device's idle seconds in the profiled calls while the host's
    innermost phase is ``search/route`` or ``routed/pack``, over the
    profiled wall, in percent. It reads the gaps as ``trace.read_profile``
    names them: the 200 longest alone, each whole under the phase open at
    its midpoint, so idle split into many short gaps goes uncounted; and
    the wall is the profiled one, which the profiler lengthens by slowing
    the host (``PERF.md`` §7)."""
    prof = rec["profile"]
    if not prof["device_events"] or prof["window_s"] <= 0 or "routed/pack" not in rec["spans"]:
        return None
    idle = sum(s for name, s in prof["idle_gaps"] if name.split(" > ")[0] in ROUTING)
    return 100.0 * idle / prof["window_s"]
