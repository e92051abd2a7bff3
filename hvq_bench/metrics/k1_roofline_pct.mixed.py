"""k1_roofline_pct.mixed: K1's least time over its device time in the profiled part, percent."""

from hvq_bench import readers


def read(rec):
    return readers.k1_roofline_pct(rec)
