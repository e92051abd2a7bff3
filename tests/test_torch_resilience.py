"""The port's failure-handling wrapper: retry and OOM-bisection semantics,
the cases of tests/test_resilience.py plus PyTorch's own out-of-memory
error, and the port's profiling helpers on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from hvq_tpu_torch.utils import profiling
from hvq_tpu_torch.utils.generators import generate_queries
from hvq_tpu_torch.utils.resilience import ResilientEngine, _is_oom, _is_transient


class FlakyEngine:
    """Fails the first `fail_n` calls with a transient error."""

    name = "flaky"

    def __init__(self, fail_n, error=lambda: RuntimeError("UNAVAILABLE: tunnel hiccup")):
        self.fail_n = fail_n
        self.error = error
        self.calls = 0

    def search(self, qs, k=100, sample_proportion=1.0):
        self.calls += 1
        if self.calls <= self.fail_n:
            raise self.error()
        ids = np.tile(np.arange(k, dtype=np.uint32), (qs.m, 1))
        return ids, np.zeros((qs.m, k), np.float32)


class OOMOverEngine:
    """Runs out of memory for batches above a size threshold; each row of
    its answer names its query (ids: the first vector component's rank in
    the set, dists: that component), so the reassembly order shows."""

    name = "oomy"

    def __init__(self, limit, error=lambda: RuntimeError("RESOURCE_EXHAUSTED: out of HBM")):
        self.limit = limit
        self.error = error
        self.batch_sizes = []

    def search(self, qs, k=100, sample_proportion=1.0):
        if qs.m > self.limit:
            raise self.error()
        self.batch_sizes.append(qs.m)
        return (np.repeat(np.arange(qs.m, dtype=np.uint32)[:, None], k, axis=1),
                qs.V[:, :1].repeat(k, axis=1).astype(np.float32))


def test_retries_transient():
    eng = FlakyEngine(fail_n=2)
    r = ResilientEngine(eng, max_retries=3, backoff_s=0.0)
    ids, d = r.search(generate_queries(4, seed=1))
    assert eng.calls == 3 and ids.shape == (4, 100)


def test_retries_exhausted_raises():
    eng = FlakyEngine(fail_n=10)
    r = ResilientEngine(eng, max_retries=2, backoff_s=0.0)
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        r.search(generate_queries(2, seed=2))
    assert eng.calls == 3


@pytest.mark.parametrize("error", [
    lambda: RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),
    lambda: torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    lambda: MemoryError(),
], ids=["resource_exhausted", "torch_cuda_oom", "memory_error"])
def test_oom_bisection_preserves_order(error):
    eng = OOMOverEngine(limit=3, error=error)
    r = ResilientEngine(eng, backoff_s=0.0)
    qs = generate_queries(10, seed=3)
    ids, d = r.search(qs)
    assert ids.shape == (10, 100)
    assert max(eng.batch_sizes) <= 3 and sum(eng.batch_sizes) == 10
    # row i of the answer is query i's, in the original order
    np.testing.assert_array_equal(d[:, 0], qs.V[:, 0])


def test_oom_is_never_retried_and_a_single_query_raises():
    eng = OOMOverEngine(limit=0, error=lambda: torch.cuda.OutOfMemoryError("CUDA out of memory"))
    r = ResilientEngine(eng, backoff_s=0.0, max_retries=5)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        r.search(generate_queries(4, seed=5))
    assert eng.batch_sizes == []


def test_non_transient_raises_immediately():
    class Broken:
        name = "broken"

        def search(self, qs, k=100, sample_proportion=1.0):
            raise ValueError("shape mismatch")

    r = ResilientEngine(Broken(), backoff_s=0.0)
    with pytest.raises(ValueError):
        r.search(generate_queries(2, seed=4))


def test_error_classes():
    assert _is_oom(torch.cuda.OutOfMemoryError("x"))
    assert _is_oom(RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"))
    assert _is_transient(RuntimeError("CUBLAS_STATUS_INTERNAL_ERROR when calling cublasSgemm"))
    # a sticky CUDA error carries no marker: raised at once
    assert not _is_transient(RuntimeError("CUDA error: an illegal memory access was encountered"))
    chained = RuntimeError("wrapper")
    chained.__cause__ = RuntimeError("DEADLINE_EXCEEDED")
    assert _is_transient(chained)


def test_wrapper_proxies_the_engine_and_passes_search_keywords():
    class Keywords(FlakyEngine):
        def search(self, qs, k=100, sample_proportion=1.0, return_dists=True):
            ids, d = super().search(qs, k, sample_proportion)
            return ids, d if return_dists else None

    eng = Keywords(fail_n=0)
    eng.query_batch = 77
    r = ResilientEngine(eng)
    assert r.query_batch == 77 and r.name == "resilient(flaky)"
    ids, d = r.search(generate_queries(3, seed=6), k=10, return_dists=False)
    assert ids.shape == (3, 10) and d is None


def test_profiling_on_the_cpu(tmp_path):
    a = torch.ones(64, 32)
    b = torch.ones(32, 16)
    assert profiling.device_memory_stats("cpu") == {}
    with profiling.trace(str(tmp_path / "prof")):
        (a @ b).sum()
    trace = tmp_path / "prof" / "trace.json"
    assert trace.is_file() and "traceEvents" in json.loads(trace.read_text())
    assert os.listdir(tmp_path / "prof") == ["trace.json"]
