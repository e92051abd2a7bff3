"""select_us_per_query.unfiltered: fenced batch/select (the level-2 select) microseconds per query."""

from hvq_bench import readers


def read(rec):
    return readers.span_us_per_query(rec, "batch/select")
