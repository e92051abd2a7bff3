"""hvq_tpu_torch — the PyTorch and CUDA port of ``hvq_tpu``.

Exact hybrid k-NN (k=100) over 100-dim float32 vectors with categorical
``C == v`` and timestamp ``l <= T <= r`` predicates, on one NVIDIA GPU by
default (or, when asked with ``device="cpu"``, the CPU through the
kernels' plain PyTorch versions). The JAX package ``hvq_tpu`` is the
reference each part is checked against; nothing here imports it or jax.
The NumPy host layer (constants, binary formats, generators, comparator,
oracle) is the port's own copy of the JAX package's.

Package layout::

    hvq_tpu_torch/
      constants.py  record widths, k, the 0.002 tolerance
      models/  engines (batched, partitioned and paged exact, and the
               sharded and partitioned_sharded mesh engines; IVF
               approximate), device database, shared finalize, the NumPy
               oracle
      parallel/  the device mesh (a (q, d) grid of torch devices, several
               virtual shards a device allowed) and the cross-shard merges
      index/   sorted views of the partitioned engine (host range routing),
               the IVF index, ``.npz`` checkpoints of both
      ops/     distances, masks, top-k, k-means, the packed scan and its
               kernels
      csrc/    hand-written CUDA kernels (built with nvcc at first use)
      utils/   binary formats, generators, comparator, phase timers and
               spans, kernel-vs-plain agreement checks, retry + OOM
               bisection, torch.profiler traces
      cli/     ``python -m hvq_tpu_torch.cli run | compare | build-index |
               gen-data | gen-queries``
      tools/   ``python -m hvq_tpu_torch.tools.bench`` (the benchmark
               runner's JSON line), ``tools.serving_latency`` (B = 1 / 16
               latency), and the probes' and kernels' measurement
               tools
      entry.py the batched search step and a mesh dry run with its
               capacity leg (the counterpart of the repository's
               ``__graft_entry__.py``)

The top level re-exports the JAX package's names: the constants, the
binary formats' readers and writers, ``get_engine``,
``available_engines`` and ``register_engine``.
"""

__version__ = "0.1.0"

from hvq_tpu_torch.constants import (  # noqa: E402,F401
    DATA_RECORD_DIM,
    DIST_TOLERANCE,
    K_DEFAULT,
    QUERY_RECORD_DIM,
    VEC_DIM,
)
from hvq_tpu_torch.models.registry import (  # noqa: E402,F401
    available_engines,
    get_engine,
    register_engine,
)
from hvq_tpu_torch.utils.formats import (  # noqa: E402,F401
    Dataset,
    QuerySet,
    read_data_bin,
    read_dist,
    read_knn,
    read_query_bin,
    save_knn,
    save_knn_dist,
)
