"""route_us_per_query.category: fenced search/route (host routing) microseconds per query."""

from hvq_bench import readers


def read(rec):
    return readers.span_us_per_query(rec, "search/route")
