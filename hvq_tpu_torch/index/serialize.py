"""Index checkpoint and resume: the counterpart of
``hvq_tpu.index.serialize``.

Both index kinds save to one ``.npz`` of host arrays with a kind tag, a
format version and the index's hyperparameters. The keys and
``_FORMAT_VERSION`` are the JAX package's, so a checkpoint written by
either package loads in the other. Neither package stores the bf16 scan
plane: a loaded partitioned index holds fp32 views.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from hvq_tpu_torch.index.ivf import IVFIndex
from hvq_tpu_torch.index.partition import PartitionedIndex
from hvq_tpu_torch.models.device_db import resolve_device

_FORMAT_VERSION = 1

# the IVF index's host arrays, saved under their own names
_IVF_ARRAYS = ("Vp", "C", "T", "oid", "d_norms", "centroids", "c_norms")
_IVF_STATS = ("cat_vals", "cat_freq", "t_sample")


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_partitioned(idx: PartitionedIndex, path: str | os.PathLike) -> None:
    """Save both sorted views; the time view is built first if it is not
    yet, as the JAX package's save does."""
    arrays = {"__kind__": np.array("partitioned"),
              "__version__": np.array(_FORMAT_VERSION)}
    for name, view in (("cat", idx.cat_view), ("time", idx.time_view)):
        arrays.update({
            f"{name}_Vp": _host(view.Vp),
            f"{name}_C": _host(view.C),
            f"{name}_T": _host(view.T),
            f"{name}_d_norms": _host(view.d_norms),
            f"{name}_oid": _host(view.oid),
            f"{name}_C_key": view.C_key,
            f"{name}_T_key": view.T_key,
            f"{name}_meta": np.array([view.n, view.db_tile], np.int64),
        })
    np.savez_compressed(os.fspath(path), **arrays)


def save_ivf(idx: IVFIndex, path: str | os.PathLike) -> None:
    np.savez_compressed(
        os.fspath(path),
        __kind__=np.array("ivf"),
        __version__=np.array(_FORMAT_VERSION),
        **{f: _host(getattr(idx, f)) for f in _IVF_ARRAYS},
        meta=np.array([idx.n, idx.cap, idx.scan_tile], np.int64),
        **{f: getattr(idx, f) for f in _IVF_STATS},
    )


def _view_arrays(z, name: str) -> SimpleNamespace:
    n, db_tile = (int(x) for x in z[f"{name}_meta"])
    return SimpleNamespace(
        **{f: z[f"{name}_{f}"] for f in ("Vp", "C", "T", "d_norms", "oid",
                                         "C_key", "T_key")},
        V_scan=None, n=n, db_tile=db_tile)


def load_index(path: str | os.PathLike, device: torch.device | str = "cuda"):
    """Load any saved index onto ``device``; returns a PartitionedIndex or
    an IVFIndex."""
    device = resolve_device(device)
    with np.load(os.fspath(path), allow_pickle=False) as z:
        version = int(z["__version__"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported index checkpoint version {version}")
        kind = str(z["__kind__"])
        if kind == "partitioned":
            time = _view_arrays(z, "time")
            return PartitionedIndex.from_arrays(
                _view_arrays(z, "cat"), time.T_key, time_view=time, device=device)
        if kind == "ivf":
            n, cap, scan_tile = (int(x) for x in z["meta"])
            return IVFIndex.from_host(
                **{f: z[f] for f in _IVF_ARRAYS + _IVF_STATS},
                n=n, cap=cap, scan_tile=scan_tile, device=device)
    raise ValueError(f"unknown index checkpoint kind {kind!r}")

