"""qps.mixed: queries completed in the window over its seconds (each call a whole query file)."""

from hvq_bench import stats


def read(rec):
    return stats.rate(rec["queries"], rec["window_s"])
