"""select_fenced_roofline_pct.mixed: one read of K1's (B, W) scores at the HBM rate over the
fenced batch/select time, per query, percent. The launches are the profiled calls', the select
the fenced calls': each side is taken per query of its own calls."""

from hvq_bench import span_readers


def read(rec):
    return span_readers.select_fenced_roofline_pct(rec)
