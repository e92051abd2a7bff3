"""rerun_per_kquery.category: the ladder's suspect queries per 1000 queries of the traced calls."""

from hvq_bench import readers


def read(rec):
    return readers.suspects_per_kquery(rec)
