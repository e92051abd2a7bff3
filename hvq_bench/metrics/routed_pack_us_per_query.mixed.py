"""routed_pack_us_per_query.mixed: fenced microseconds of the program's routed/pack spans per query."""

from hvq_bench import span_readers


def read(rec):
    return span_readers.routed_pack_us_per_query(rec)
