"""mesh_merge_us_per_query.mixed: fenced mesh/merge (the shards' top-k' tiles
merged on the first card, the certificate terms' minimum over the shards)
microseconds per query."""

from hvq_bench import readers


def read(rec):
    return readers.span_us_per_query(rec, "mesh/merge")
