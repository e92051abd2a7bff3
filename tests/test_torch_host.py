"""The port's own host layer against the JAX package's.

``hvq_tpu_torch`` keeps NumPy copies of ``constants``, ``utils/formats``,
``utils/generators``, ``utils/compare`` and ``models/oracle`` so that it
imports nothing of ``hvq_tpu``. Here both packages get the same inputs
from the same numpy seeds and must agree exactly: bit-identical arrays,
byte-identical files (each package reads the other's), equal comparison
results and equal oracle answers. The certificate stress test runs the
port's K1 engine path on the CPU (its plain version).
"""

import dataclasses

import numpy as np
import pytest

from hvq_tpu import constants as jconst
from hvq_tpu.models import oracle as joracle
from hvq_tpu.utils import compare as jcompare
from hvq_tpu.utils import formats as jformats
from hvq_tpu.utils import generators as jgen
from hvq_tpu_torch import constants as tconst
from hvq_tpu_torch.models import oracle as toracle
from hvq_tpu_torch.utils import compare as tcompare
from hvq_tpu_torch.utils import formats as tformats
from hvq_tpu_torch.utils import generators as tgen

from torch_certificate import certificate_stress


def _same_fields(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        assert x.tobytes() == y.tobytes(), f.name


def test_constants_match():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names and all(getattr(tconst, n) == getattr(jconst, n) for n in names)


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("categories", [None, 30, 1000])
def test_generators_are_bit_identical(seed, categories):
    _same_fields(tgen.generate_dataset(777, seed=seed, categories=categories),
                 jgen.generate_dataset(777, seed=seed, categories=categories))
    _same_fields(tgen.generate_queries(61, seed=seed + 1, categories=categories),
                 jgen.generate_queries(61, seed=seed + 1, categories=categories))


def test_generator_options_are_bit_identical():
    kw = dict(clusters=7, cluster_std=0.5)
    _same_fields(tgen.generate_dataset(500, seed=3, **kw),
                 jgen.generate_dataset(500, seed=3, **kw))
    kw = dict(types=(1, 3), clusters=7, centers_seed=2, categories=20)
    _same_fields(tgen.generate_queries(50, seed=4, **kw),
                 jgen.generate_queries(50, seed=4, **kw))


def test_files_are_byte_identical_and_cross_read(tmp_path):
    ds = tgen.generate_dataset(1500, seed=5, categories=40)
    qs = tgen.generate_queries(23, seed=6, categories=40)
    ids, _ = toracle.search_oracle_batched(ds, qs)
    for pkg, fm in (("t", tformats), ("j", jformats)):
        fm.write_data_bin(tmp_path / f"{pkg}.data", ds)
        fm.write_query_bin(tmp_path / f"{pkg}.query", qs)
        fm.save_knn(ids, tmp_path / f"{pkg}.out")
        fm.save_knn_dist(ds, qs, ids, tmp_path / f"{pkg}.out.dist")
    for ext in ("data", "query", "out", "out.dist"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    # each package reads the other's files
    for reader, writer in ((tformats, "j"), (jformats, "t")):
        _same_fields(reader.read_data_bin(tmp_path / f"{writer}.data"), ds)
        _same_fields(reader.read_query_bin(tmp_path / f"{writer}.query"), qs)
        assert np.array_equal(reader.read_knn(tmp_path / f"{writer}.out"), ids)
        assert np.array_equal(reader.read_dist(tmp_path / f"{writer}.out.dist"),
                              jformats.read_dist(tmp_path / "j.out.dist"))


def test_truncated_file_raises_in_both(tmp_path):
    ds = tgen.generate_dataset(10, seed=1)
    tformats.write_data_bin(tmp_path / "d", ds)
    raw = (tmp_path / "d").read_bytes()
    (tmp_path / "d").write_bytes(raw[:-8])
    for fm in (tformats, jformats):
        with pytest.raises(ValueError):
            fm.read_data_bin(tmp_path / "d")


def test_recompute_result_distances_match():
    ds = tgen.generate_dataset(900, seed=8, categories=20)
    qs = tgen.generate_queries(17, seed=9, categories=20)
    ids = np.random.default_rng(10).integers(0, ds.n, (qs.m, 100)).astype(np.int64)
    a = tformats.recompute_result_distances(ds, qs, ids)
    b = jformats.recompute_result_distances(ds, qs, ids)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("shift", [0.0, 0.001, 0.0025, 1.0])
def test_compare_distances_and_recall_match(shift):
    rng = np.random.default_rng(11)
    a = rng.uniform(0, 100, (13, 100)).astype(np.float32)
    b = a.copy()
    b[3, 7] += shift
    ta, ja = tcompare.compare_distances(a, b), jcompare.compare_distances(a, b)
    assert dataclasses.asdict(ta) == dataclasses.asdict(ja) and ta.ok == ja.ok
    ids = rng.integers(0, 1000, (13, 100))
    other = ids.copy()
    other[2, :5] = 5000 + np.arange(5)
    for args in ((ids, other), (ids, other, a, b)):
        assert tcompare.recall_at_k(*args) == jcompare.recall_at_k(*args)


@pytest.mark.parametrize("sample_proportion", [1.0, 0.5])
def test_oracles_give_the_same_answers(sample_proportion):
    ds = tgen.generate_dataset(3000, seed=12, categories=25)
    qs = tgen.generate_queries(20, seed=13, categories=25)
    for t_fn, j_fn in ((toracle.search_oracle, joracle.search_oracle),
                       (toracle.search_oracle_batched, joracle.search_oracle_batched)):
        ti, td = t_fn(ds, qs, sample_proportion=sample_proportion)
        ji, jd = j_fn(ds, qs, sample_proportion=sample_proportion)
        assert np.array_equal(ti, ji) and np.array_equal(td, jd)
    ti, td = toracle.OracleEngine(ds, device="cpu").search(qs)
    ji, jd = joracle.OracleEngine(ds).search(qs)
    assert np.array_equal(ti, ji) and np.array_equal(td, jd)


def test_registry_oracle_is_the_ports_copy():
    from hvq_tpu_torch import get_engine

    assert get_engine("oracle") is toracle.OracleEngine


@pytest.mark.parametrize("scan_store", ["fp32", "bf16"])
@pytest.mark.parametrize("scale", [1.0, 64.0, 4096.0])
def test_certificate_slack_boundary_stress_on_cpu(scan_store, scale):
    """tests/test_certificate.py's boundary sweep through the port's
    ``BatchedEngine(scan_impl="v3")`` on the CPU (K1's plain version): no
    kernel launches, oracle-exact at every scale."""
    counts = certificate_stress("cpu", scan_store, scale)
    assert counts["wgmma"] == 0 and counts["simt"] == 0
