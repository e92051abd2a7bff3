"""hvq_tpu_torch — the PyTorch and CUDA port of ``hvq_tpu``.

Exact hybrid k-NN (k=100) over 100-dim float32 vectors with categorical
``C == v`` and timestamp ``l <= T <= r`` predicates, on one NVIDIA GPU
(or the CPU, through the kernels' plain PyTorch versions). The JAX package
``hvq_tpu`` is the reference each part is checked against; its NumPy host
layer (constants, binary formats, generators, comparator, oracle) is
imported from there, and nothing here imports jax.

Package layout::

    hvq_tpu_torch/
      models/  engines (batched and partitioned exact), device database,
               shared finalize
      index/   sorted views of the partitioned engine (host range routing)
      ops/     distances, masks, top-k, the packed scan and its kernels
      csrc/    hand-written CUDA kernels (built with nvcc at first use)
      utils/   phase timers
      cli/     ``python -m hvq_tpu_torch.cli run``
"""

__version__ = "0.1.0"

from hvq_tpu_torch.models.registry import available_engines, get_engine  # noqa: E402,F401
