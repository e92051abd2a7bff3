"""Binary formats of the SIGMOD contest datasets and result files.

Mirrors the framing of the reference's ``include/io.h`` exactly:

* **Data file** (``ReadBin(path, 102, ...)``, io.h:111-136): a leading
  ``uint32 N`` followed by ``N`` records of 102 float32s — ``C`` (categorical
  attribute), ``T`` (timestamp attribute), then the 100 vector dims.
* **Query file** (``ReadBin(path, 104, ...)``): leading ``uint32 M`` followed
  by ``M`` records of 104 float32s — ``query_type`` (0..3), ``v``, ``l``,
  ``r``, then the 100 query-vector dims (reference README.md:40-47).
* **Output file** (``SaveKNN``, io.h:23-36): ``M × 100`` uint32 neighbor ids,
  **no header** (the reference's deliberate quirk).
* **Distance file** (``SaveKNNFull``, io.h:50-78): leading ``uint32 M``
  followed by ``M × 100`` float32 distances, each *recomputed* from the
  gathered neighbor record against the query vector, skipping the two
  attribute dims (io.h:38-48 ``calc_dist``). Distances — not ids — are the
  reference's correctness contract (src/compare_data.cpp:82-94).

Reading goes through the port's C++ mmap reader (``hvq_tpu_torch.native``,
a parallel copy-out) when it is built, as the JAX package's reader does,
and through ``numpy.memmap`` when there is no C++ compiler to build it;
either way the 10M-row (~4 GB) file never makes a record-at-a-time pass
like the reference's ``ifs.read`` loop (io.h:125-133).

The PyTorch port's own copy of ``hvq_tpu.utils.formats``: the same names,
arrays and bytes. Files written by either package read in the other.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from hvq_tpu_torch import constants as _c


@dataclasses.dataclass
class Dataset:
    """A database of vectors with categorical and timestamp attributes.

    Column-major split of the reference's row records: keeping ``C``, ``T``
    and the vector block as separate arrays means predicate masks touch 4
    bytes/row instead of 408 and the vector block feeds matmuls directly.
    """

    C: np.ndarray  # (n,) float32 — categorical attribute (record dim 0)
    T: np.ndarray  # (n,) float32 — timestamp attribute (record dim 1)
    V: np.ndarray  # (n, 100) float32 — the vectors (record dims 2..101)

    @property
    def n(self) -> int:
        return self.V.shape[0]

    def record_matrix(self) -> np.ndarray:
        """Reassemble the (n, 102) row-record layout (io.h framing)."""
        return np.concatenate(
            [self.C[:, None], self.T[:, None], self.V], axis=1
        ).astype(np.float32)


@dataclasses.dataclass
class QuerySet:
    """A batch of hybrid queries (reference README.md:40-53).

    ``query_type`` semantics: 0 = vector only; 1 = ``C == v``;
    2 = ``l <= T <= r``; 3 = both. Unused predicate fields hold -1.
    """

    qtype: np.ndarray  # (m,) int32
    v: np.ndarray      # (m,) float32
    l: np.ndarray      # (m,) float32
    r: np.ndarray      # (m,) float32
    V: np.ndarray      # (m, 100) float32

    @property
    def m(self) -> int:
        return self.V.shape[0]

    def record_matrix(self) -> np.ndarray:
        """Reassemble the (m, 104) row-record layout."""
        return np.concatenate(
            [
                self.qtype.astype(np.float32)[:, None],
                self.v[:, None],
                self.l[:, None],
                self.r[:, None],
                self.V,
            ],
            axis=1,
        ).astype(np.float32)


def _read_records(path: str | os.PathLike, record_dim: int) -> np.ndarray:
    """Read a count-prefixed float32 record file into an (N, record_dim) array.

    Format authority: reference io.h:111-136 (``uint32 N`` then N records).
    Through the native mmap reader when it is built (its errors raise),
    through a NumPy memmap when no C++ compiler can build it.
    """
    path = os.fspath(path)
    from hvq_tpu_torch import native

    if native.available():
        return native.read_records(path, record_dim)
    header = np.fromfile(path, dtype=np.uint32, count=1)
    if header.size != 1:
        raise ValueError(f"{path}: missing uint32 count header")
    n = int(header[0])
    mm = np.memmap(path, dtype=np.float32, mode="r", offset=4)
    expected = n * record_dim
    if mm.size < expected:
        raise ValueError(
            f"{path}: header says {n} records of {record_dim} floats "
            f"({expected} values) but file holds {mm.size}"
        )
    out = np.array(mm[:expected], dtype=np.float32).reshape(n, record_dim)
    del mm
    return out


def read_data_bin(path: str | os.PathLike) -> Dataset:
    """Read a dataset file (reference ``ReadBin(path, 102, ...)``, io.h:111)."""
    rec = _read_records(path, _c.DATA_RECORD_DIM)
    return Dataset(
        C=np.ascontiguousarray(rec[:, 0]),
        T=np.ascontiguousarray(rec[:, 1]),
        V=np.ascontiguousarray(rec[:, 2:]),
    )


def read_query_bin(path: str | os.PathLike) -> QuerySet:
    """Read a query file (reference ``ReadBin(path, 104, ...)``, io.h:111)."""
    rec = _read_records(path, _c.QUERY_RECORD_DIM)
    return QuerySet(
        qtype=np.ascontiguousarray(rec[:, 0]).astype(np.int32),
        v=np.ascontiguousarray(rec[:, 1]),
        l=np.ascontiguousarray(rec[:, 2]),
        r=np.ascontiguousarray(rec[:, 3]),
        V=np.ascontiguousarray(rec[:, 4:]),
    )


def write_data_bin(path: str | os.PathLike, ds: Dataset) -> None:
    """Write a dataset file in the reference's io.h framing."""
    rec = ds.record_matrix()
    with open(path, "wb") as f:
        np.uint32(rec.shape[0]).tofile(f)
        rec.astype(np.float32).tofile(f)


def write_query_bin(path: str | os.PathLike, qs: QuerySet) -> None:
    """Write a query file in the reference's io.h framing."""
    rec = qs.record_matrix()
    with open(path, "wb") as f:
        np.uint32(rec.shape[0]).tofile(f)
        rec.astype(np.float32).tofile(f)


def save_knn(ids: np.ndarray, path: str | os.PathLike) -> None:
    """Write result ids: ``M × k`` uint32, **headerless** (io.h:23-36).

    The reference hard-asserts k == 100 (io.h:25 ``assert(knns.size() ==
    K)``); contest files always use k=100, but any k is accepted here —
    the file stays headerless, so readers must pass the matching ``k``
    to :func:`read_knn`.
    """
    ids = np.asarray(ids)
    if ids.ndim != 2:
        raise ValueError(f"expected (M, k) ids, got {ids.shape}")
    ids.astype(np.uint32).tofile(os.fspath(path))


def read_knn(path: str | os.PathLike, k: int = _c.K_DEFAULT) -> np.ndarray:
    """Read a headerless result-id file back into (M, k) uint32."""
    flat = np.fromfile(os.fspath(path), dtype=np.uint32)
    if flat.size % k:
        raise ValueError(f"{path}: size {flat.size} not a multiple of k={k}")
    return flat.reshape(-1, k)


def recompute_result_distances(
    ds: Dataset, qs: QuerySet, ids: np.ndarray
) -> np.ndarray:
    """Recompute result distances from gathered neighbor vectors.

    This mirrors the reference driver exactly: ``SaveKNNFull`` gathers each
    result id's full record and recomputes a scalar L2² against the query
    vector, skipping the two attribute dims (io.h:50-78, calc_dist io.h:38-48,
    driven from src/test.cpp:95-110). The engine's internal distances are
    never written — the .dist contract is over this recomputation.
    """
    ids = np.asarray(ids, dtype=np.int64)
    gathered = ds.V[ids]                       # (M, k, 100)
    diff = gathered - qs.V[:, None, :]         # (M, k, 100)
    return np.einsum("mkd,mkd->mk", diff, diff).astype(np.float32)


def save_knn_dist(
    ds: Dataset, qs: QuerySet, ids: np.ndarray, path: str | os.PathLike
) -> np.ndarray:
    """Write the ``.dist`` file: uint32 M header + M×k float32 (io.h:50-78).

    Returns the recomputed distance matrix for convenience.
    """
    d = recompute_result_distances(ds, qs, ids)
    with open(path, "wb") as f:
        np.uint32(d.shape[0]).tofile(f)
        d.astype(np.float32).tofile(f)
    return d


def read_dist(path: str | os.PathLike, k: int | None = None) -> np.ndarray:
    """Read a ``.dist`` file (``ReadBinFull<float>``, io.h:80-105).

    ``k`` defaults to inference from the file size and the ``M`` header
    (the header makes the width recoverable, unlike the headerless id
    file); pass it explicitly to enforce a specific width.
    """
    path = os.fspath(path)
    header = np.fromfile(path, dtype=np.uint32, count=1)
    if header.size != 1:
        raise ValueError(f"{path}: missing uint32 count header")
    m = int(header[0])
    flat = np.fromfile(path, dtype=np.float32, offset=4)
    if k is None:
        if m == 0:
            return flat.reshape(0, _c.K_DEFAULT)
        k = flat.size // m
        if k == 0:
            raise ValueError(f"{path}: {flat.size} distances for {m} queries")
    if flat.size != m * k:
        raise ValueError(f"{path}: expected {m * k} distances, got {flat.size}")
    return flat.reshape(m, k)
