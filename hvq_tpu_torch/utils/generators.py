"""Synthetic dataset and query generators.

Capability parity with the reference's C generators (src/write_data.c:15-49,
src/write_query.c:17-64), vectorized with NumPy instead of a per-float
``rand()`` loop:

* data records: ``C ~ U[-1, 1]``, ``T ~ U[-3, 3]``, 100 dims ``~ U[-6, 6]``
  (write_data.c:26-42).
* query records: ``type ~ U{0..3}``; ``v ~ U[-1, 1]`` only for types 1/3 else
  -1; ``l ~ U[-3, 3]`` and ``r ~ U[l, 4]`` only for types 2/3 else -1; 100
  dims ``~ U[-6, 6]`` (write_query.c:28-58).

The reference generators emit a *continuous* ``C``, which makes ``C == v``
essentially never match for random ``v`` — a quirk SURVEY.md §4 notes (the
real contest data has *discretized* C, reference README.md:29). ``categories``
adds the realistic mode: when set, both data ``C`` and query ``v`` are drawn
uniformly from ``categories`` distinct discretized values, so filtered query
types exercise non-empty candidate sets.

The PyTorch port's own copy of ``hvq_tpu.utils.generators``: the same seeds
give the same arrays, bit for bit.
"""

from __future__ import annotations

import numpy as np

from hvq_tpu_torch import constants as _c
from hvq_tpu_torch.utils.formats import Dataset, QuerySet


def _category_values(categories: int) -> np.ndarray:
    """Discretized category levels, evenly spaced in the reference's C range."""
    return np.linspace(-1.0, 1.0, categories, dtype=np.float32)


def generate_dataset(
    n: int,
    seed: int = 0,
    categories: int | None = None,
    clusters: int | None = None,
    cluster_std: float = 1.0,
) -> Dataset:
    """Generate n records matching src/write_data.c's value distributions.

    ``clusters`` switches the vector block from the reference's i.i.d.
    uniform fill (write_data.c:38, which has *no* nearest-neighbor structure
    — the worst case for any ANN index) to a mixture of Gaussians with
    uniform-random centers in the same [-6, 6] box: the realistic regime the
    contest data lives in and the one approximate modes are graded on.
    """
    rng = np.random.default_rng(seed)
    if categories is None:
        C = rng.uniform(-1.0, 1.0, size=n).astype(np.float32)
    else:
        C = _category_values(categories)[rng.integers(0, categories, size=n)]
    T = rng.uniform(-3.0, 3.0, size=n).astype(np.float32)
    if clusters is None:
        # draw float32 directly: half the memory traffic of float64+cast
        V = (rng.random((n, _c.VEC_DIM), dtype=np.float32) * 12.0 - 6.0)
    else:
        centers = _mixture_centers(seed, clusters)
        assign = rng.integers(0, clusters, size=n)
        V = (
            centers[assign]
            + rng.normal(0.0, cluster_std, size=(n, _c.VEC_DIM))
        ).astype(np.float32)
    return Dataset(C=C, T=T, V=V)


def _mixture_centers(centers_seed: int, clusters: int) -> np.ndarray:
    """Deterministic mixture centers, shareable between data and queries."""
    return np.random.default_rng(10_000 + centers_seed).uniform(
        -6.0, 6.0, size=(clusters, _c.VEC_DIM)
    )


def generate_queries(
    m: int,
    seed: int = 1,
    categories: int | None = None,
    types: tuple[int, ...] = (0, 1, 2, 3),
    clusters: int | None = None,
    centers_seed: int = 0,
    cluster_std: float = 1.0,
) -> QuerySet:
    """Generate m hybrid queries matching src/write_query.c's semantics.

    ``types`` restricts which query types are drawn (uniformly), which the
    reference cannot do but tests want. ``clusters`` + ``centers_seed``
    draw query vectors from the same mixture as a clustered dataset
    generated with ``seed == centers_seed``.
    """
    rng = np.random.default_rng(seed)
    qtype = rng.choice(np.asarray(types, dtype=np.int32), size=m)

    has_c = np.isin(qtype, (1, 3))
    has_t = np.isin(qtype, (2, 3))

    if categories is None:
        v_drawn = rng.uniform(-1.0, 1.0, size=m).astype(np.float32)
    else:
        v_drawn = _category_values(categories)[
            rng.integers(0, categories, size=m)
        ]
    v = np.where(has_c, v_drawn, np.float32(-1.0)).astype(np.float32)

    l_drawn = rng.uniform(-3.0, 3.0, size=m).astype(np.float32)
    l = np.where(has_t, l_drawn, np.float32(-1.0)).astype(np.float32)
    # write_query.c:47 draws r uniformly in [l, 4] so the range is never empty.
    r_drawn = rng.uniform(l_drawn, 4.0).astype(np.float32)
    r = np.where(has_t, r_drawn, np.float32(-1.0)).astype(np.float32)

    if clusters is None:
        V = rng.uniform(-6.0, 6.0, size=(m, _c.VEC_DIM)).astype(np.float32)
    else:
        centers = _mixture_centers(centers_seed, clusters)
        assign = rng.integers(0, clusters, size=m)
        V = (
            centers[assign]
            + rng.normal(0.0, cluster_std, size=(m, _c.VEC_DIM))
        ).astype(np.float32)
    return QuerySet(qtype=qtype.astype(np.int32), v=v, l=l, r=r, V=V)
