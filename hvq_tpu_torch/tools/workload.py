"""The mixed workloads that ``chip_smoke.py`` runs, defined once for its
phases.

Rows and queries come from the port's generators at 1000 categories, so
the type-1 and type-3 predicates match rows. A batched search runs 10⁴
mixed queries (types 0–3, seed + 1); the partitioned engine runs 4·10⁴
over the D=10⁷ rows: those 10⁴, then 3·10⁴ from seed + 3.
"""

from __future__ import annotations

import numpy as np

from hvq_tpu_torch.utils.formats import Dataset, QuerySet
from hvq_tpu_torch.utils.generators import generate_dataset, generate_queries

CATEGORIES = 1000
M_QUERIES = 10_000
PARTITIONED_ROWS = 10_000_000
PARTITIONED_SEED = 200
PARTITIONED_QUERIES = 4 * M_QUERIES


def mixed(n: int, seed: int) -> tuple[Dataset, QuerySet]:
    """``n`` rows from ``seed`` and ``M_QUERIES`` mixed queries from
    ``seed + 1``."""
    ds = generate_dataset(n, seed=seed, categories=CATEGORIES)
    qs = generate_queries(M_QUERIES, seed=seed + 1, categories=CATEGORIES)
    return ds, qs


def partitioned_queries(qs: QuerySet, seed: int = PARTITIONED_SEED) -> QuerySet:
    """``qs`` followed by mixed queries from ``seed + 3``, up to
    ``PARTITIONED_QUERIES`` in all."""
    more = generate_queries(PARTITIONED_QUERIES - qs.m, seed=seed + 3,
                            categories=CATEGORIES)
    return QuerySet(**{f: np.concatenate([getattr(qs, f), getattr(more, f)])
                       for f in ("qtype", "v", "l", "r", "V")})
