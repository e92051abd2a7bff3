"""Every exact engine of the port on the benchmark's query types, on the CPU.

The benchmark's cells send the contest's query types in named mixes
(``mixed``: types 0-3, ``unfiltered``: type 0, ``category``: types 1 and
3) and call ``engine.search(..., return_dists=False)``; ``time`` (type 2
alone) adds the mix that drives the partitioned engines' windows and
their time view. Each engine here is held, over every query of each mix,
to the JAX package's float64 oracle on the JAX package's data (ids and
distances, the 0.002 contract and recall@100 = 1.0), and its ids-only
search to its full search's ids.

One dataset (16,084 rows, 40 categories, 512-row tiles) serves every
engine: the paged engine streams it in four windows, the mesh engines
split it over 4 CPU shards, and the partitioned engines route spans of
up to 1,024 rows and take windows for wide type-2 batches, so that
``mixed`` runs each of their paths: full, windowed and routed.
"""

import numpy as np
import pytest

from hvq_tpu.models.oracle import search_oracle
from hvq_tpu.utils.compare import recall_at_k
from hvq_tpu.utils.formats import recompute_result_distances
from hvq_tpu.utils.generators import generate_dataset, generate_queries
from hvq_tpu_torch import get_engine
from hvq_tpu_torch.parallel.mesh import make_mesh

from conftest import assert_results_match

ROWS, CATEGORIES, DT, B = 16384 - 300, 40, 512, 32
QUERIES = 512           # a mix: 16 query batches, so wide type-2 spans fill windows
ROUTE = dict(route_buckets=(1024,), time_view_min_queries=1)

# each engine's keywords beyond the tile and the batch
ENGINES = {"batched": {}, "paged": dict(window_rows=4096), "partitioned": ROUTE,
           "sharded": {}, "partitioned_sharded": ROUTE}
MESH_ENGINES = ("sharded", "partitioned_sharded")
MIXES = {"mixed": (0, 1, 2, 3), "unfiltered": (0,), "category": (1, 3), "time": (2,)}

_full = {}      # (engine, mix) -> the full search's ids, dists and suspects


@pytest.fixture(scope="module")
def ds():
    return generate_dataset(ROWS, seed=220, categories=CATEGORIES)


@pytest.fixture(scope="module")
def traffic(ds):
    """Each mix's queries and the oracle's answer to them."""
    out = {}
    for i, (mix, types) in enumerate(MIXES.items()):
        qs = generate_queries(QUERIES, seed=221 + i, categories=CATEGORIES, types=types)
        out[mix] = (qs, *search_oracle(ds, qs))
    return out


@pytest.fixture(scope="module")
def engines(ds):
    """Each engine, built once on first use."""
    built = {}

    def get(name):
        if name not in built:
            place = (dict(mesh=make_mesh(devices=["cpu"] * 4)) if name in MESH_ENGINES
                     else dict(device="cpu"))
            built[name] = get_engine(name)(ds, db_tile=DT, query_batch=B, **place,
                                           **ENGINES[name])
        return built[name]

    return get


def _suspects(eng) -> int:
    """The suspect queries the last search's rerun ladder took."""
    return (getattr(eng, "last_reruns", None) or eng.last_ladder)["suspects"]


def _full_search(eng, name, mix, qs):
    if (name, mix) not in _full:
        ids, dists = eng.search(qs)
        _full[name, mix] = ids, dists, _suspects(eng)
    return _full[name, mix]


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("name", ENGINES)
def test_exact_engine_meets_the_contract_over_every_query(ds, traffic, engines, name, mix):
    qs, oids, odists = traffic[mix]
    eng = engines(name)
    ids, dists, _ = _full_search(eng, name, mix, qs)
    assert ids.dtype == np.uint32 and dists.dtype == np.float32
    assert ids.shape == dists.shape == (qs.m, 100)
    assert_results_match(ds, qs, ids, dists, oids, odists)
    assert recall_at_k(ids, oids, dists, odists) == 1.0
    if name == "paged":
        assert len(eng.windows) == 4
    if name.startswith("partitioned") and mix in ("mixed", "time"):
        # wide spans take windows of the time view; narrow ones route on
        # it, except on the mesh, whose dealt view routes none
        route = eng.last_route
        assert route["windowed"] >= B and eng.last_windows, route
        if name == "partitioned":
            assert route["routed_time"] >= 1, route
        else:
            assert route["routed_time"] == 0 and route["time_unrouted"] >= 1, route
    if name.startswith("partitioned") and mix == "category":
        # every span fits a bucket: routed, or on the mesh dense where it
        # straddles two shards
        route = eng.last_route
        assert route["routed_cat"] + route["dense_straddling"] == qs.m, route
        assert route["dense_straddling"] == 0 or name != "partitioned", route


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("name", ENGINES)
def test_ids_only_search_returns_the_full_searchs_ids(ds, traffic, engines, name, mix):
    """``return_dists=False``, as the benchmark calls every engine: the
    full search's ids (rows that tie exactly may trade places) and the
    same suspects on the rerun ladder."""
    qs = traffic[mix][0]
    eng = engines(name)
    ids, _, suspects = _full_search(eng, name, mix, qs)
    ids2, none = eng.search(qs, return_dists=False)
    assert none is None
    assert ids2.dtype == np.uint32 and ids2.shape == ids.shape
    assert _suspects(eng) == suspects
    moved = ids2 != ids
    if moved.any():
        d2 = recompute_result_distances(ds, qs, ids2.astype(np.int64))
        d1 = recompute_result_distances(ds, qs, ids.astype(np.int64))
        np.testing.assert_array_equal(d2[moved], d1[moved])
