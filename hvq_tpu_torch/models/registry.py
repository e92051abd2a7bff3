"""Runtime engine registry: the counterpart of ``hvq_tpu.models.registry``.

Engine protocol::

    engine = get_engine(name)(dataset, device="cuda", **kwargs)
    ids, dists = engine.search(queries, k=100, sample_proportion=1.0)

``ids``: (m, k) uint32 neighbour ids ascending by distance; ``dists``:
(m, k) float32 exact distances. Engines import lazily, so importing the
registry loads no engine module. The mesh engines (``sharded``,
``partitioned_sharded``) also take ``mesh=`` (``parallel.mesh.make_mesh``);
without one, ``device`` picks it: every visible card by default, one CPU
shard for ``device="cpu"``.
"""

from __future__ import annotations

import importlib
from typing import Callable

# name → (module, class). The oracle is the port's NumPy oracle, a copy of
# the JAX package's; it accepts and ignores ``device=``.
_ENGINES = {
    "batched": ("hvq_tpu_torch.models.batched", "BatchedEngine"),
    "ivf": ("hvq_tpu_torch.models.ivf", "IVFEngine"),
    "oracle": ("hvq_tpu_torch.models.oracle", "OracleEngine"),
    "paged": ("hvq_tpu_torch.models.paged", "PagedEngine"),
    "partitioned": ("hvq_tpu_torch.models.partitioned", "PartitionedEngine"),
    "partitioned_sharded": ("hvq_tpu_torch.models.partitioned_sharded",
                            "ShardedPartitionedEngine"),
    "sharded": ("hvq_tpu_torch.models.sharded", "ShardedEngine"),
}


# name → class, for engines registered by :func:`register_engine`
_REGISTERED: dict[str, Callable] = {}


def register_engine(name: str):
    """Class decorator: sets ``cls.name`` and makes ``get_engine(name)``
    return the class (a registered name shadows a built-in one)."""
    def deco(cls):
        cls.name = name
        _REGISTERED[name] = cls
        return cls

    return deco


def get_engine(name: str) -> Callable:
    if name in _REGISTERED:
        return _REGISTERED[name]
    if name not in _ENGINES:
        raise KeyError(f"unknown engine {name!r}; available: {available_engines()}")
    module, cls = _ENGINES[name]
    return getattr(importlib.import_module(module), cls)


def available_engines() -> list[str]:
    return sorted({*_ENGINES, *_REGISTERED})
