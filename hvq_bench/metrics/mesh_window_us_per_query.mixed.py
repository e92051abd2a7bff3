"""mesh_window_us_per_query.mixed: fenced search/window (every wide type-2
window batch: each card's K1 over its tiles of the window, the merge, the
certificate) microseconds per query, where the program runs its windows on
the mesh (it opens mesh/window); else nothing."""

from hvq_bench import readers


def read(rec):
    if "mesh/window" not in rec["spans"]:
        return None
    return readers.span_us_per_query(rec, "search/window")
