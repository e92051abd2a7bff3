"""Device mesh: the counterpart of ``hvq_tpu.parallel.mesh``.

The JAX mesh engines are one controller over a ``("q", "d")`` device mesh:
database rows are sharded over "d", query batches over "q". Here a mesh is
a (n_q, n_d) grid of ``torch.device`` driven from one process; the engines
run each shard's work on its device and merge on the first device of each
q row (``parallel.collectives``).

Devices may repeat. The tests build 8 CPU shards (``devices=["cpu"] * 8``),
as the JAX tests use 8 virtual XLA CPU devices, and one card can hold
several virtual shards. Where shards, or q rows, share a device, the
placement helpers give them views of one copy of their rows, so n virtual
shards of one card cost one database.

A mesh across processes (``torch.distributed``) is not built: the JAX
package has none either.
"""

from __future__ import annotations

import numpy as np
import torch

from hvq_tpu_torch.models.device_db import resolve_device, upload, upload_async


class Mesh:
    """A (n_q, n_d) grid of devices with axes "q" (query batch) and "d"
    (database rows); ``shape`` reads as the JAX mesh's (``mesh.shape["d"]``)."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty (q, d) grid, got {devices.shape}")
        types = {d.type for d in devices.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh's devices must be of one type, got {sorted(types)}")
        self.devices = devices
        self.shape = {"q": devices.shape[0], "d": devices.shape[1]}

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def distinct(self) -> list:
        """The mesh's devices, each once, in row-major order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(
    n_db_shards: int | None = None,
    n_query_shards: int = 1,
    devices=None,
) -> Mesh:
    """Build a ("q", "d") mesh. Defaults to every visible CUDA device on the
    "d" axis; with no card that raises, and the CPU comes only from an
    explicit ``devices`` (e.g. ``["cpu"] * 8``)."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "make_mesh() puts every visible CUDA device on the mesh and "
                "there is none; pass devices= (e.g. ['cpu'] * 8) for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(count)]
    flat = np.empty(len(devices), dtype=object)
    flat[:] = [resolve_device(d) for d in devices]
    if n_db_shards is None:
        n_db_shards = flat.size // n_query_shards
    if n_db_shards * n_query_shards != flat.size:
        raise ValueError(
            f"{flat.size} devices cannot form a "
            f"{n_query_shards}x{n_db_shards} (q, d) mesh"
        )
    return Mesh(flat.reshape(n_query_shards, n_db_shards))


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: through a pinned buffer from the host, a copy
    between devices, ``x`` itself where it already is."""
    if x.device == device:
        return x
    if x.device.type == "cpu":
        return upload(x, device)
    return x.to(device)


def shard_rows(mesh: Mesh, rows) -> list:
    """(n_q, n_d) grid of row slabs: slab j is rows [j·L, (j+1)·L), L =
    len(rows) / n_d, on ``mesh.devices[i, j]``.

    ``rows`` is a host array or a tensor on any device. Each device
    receives the slabs it holds once, as one block, and every slab on it is
    a view of that block: n_d virtual shards of one device cost one copy,
    and replicas over "q" on a device share it. A tensor already on a
    device that holds all of its slabs is viewed, not copied; one that
    holds only some copies them, so the whole tensor can be freed."""
    if isinstance(rows, np.ndarray):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    n_q, n_d = mesh.devices.shape
    if rows.shape[0] % n_d:
        raise ValueError(f"{rows.shape[0]} rows do not split into {n_d} shards")
    L = rows.shape[0] // n_d
    where = {}
    for dev in mesh.distinct():
        js = sorted({j for i in range(n_q) for j in range(n_d)
                     if mesh.devices[i, j] == dev})
        if js == list(range(js[0], js[-1] + 1)):
            src = rows[js[0] * L : (js[-1] + 1) * L]
            if len(js) < n_d and rows.device == dev:
                src = src.clone()
        else:
            src = torch.cat([rows[j * L : (j + 1) * L] for j in js])
        where[dev] = (_to(src, dev), {j: p for p, j in enumerate(js)})
    grid = []
    for i in range(n_q):
        row = []
        for j in range(n_d):
            block, pos = where[mesh.devices[i, j]]
            row.append(block[pos[j] * L : (pos[j] + 1) * L])
        grid.append(row)
    return grid


def replicate(mesh: Mesh, x) -> list:
    """(n_q, n_d) grid of ``x`` (a host array or tensor): one copy a
    distinct device, the same tensor wherever the device repeats."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    placed = {dev: _to(x, dev) for dev in mesh.distinct()}
    return [[placed[d] for d in row] for row in mesh.devices]


def split_queries(mesh: Mesh, block: np.ndarray) -> list:
    """(n_q, n_d) grid of a host (B, w) query block split along "q": q row
    i holds rows [i·B/n_q, (i+1)·B/n_q), uploaded once to each distinct
    device of its row without waiting for the device."""
    n_q = mesh.shape["q"]
    if block.shape[0] % n_q:
        raise ValueError(f"{block.shape[0]} queries do not split over {n_q} q rows")
    Bq = block.shape[0] // n_q
    grid = []
    for i, row in enumerate(mesh.devices):
        part = block[i * Bq : (i + 1) * Bq]
        placed = {dev: upload_async(part, dev) for dev in dict.fromkeys(row)}
        grid.append([placed[d] for d in row])
    return grid


def engine_mesh(mesh: Mesh | None, device) -> Mesh:
    """The mesh a mesh engine runs on, from its ``mesh`` and ``device``
    keywords. No mesh: ``device`` None or ``"cuda"`` gives every visible
    card (raising with none), another device type its one device (the
    CPU: one shard), a device with an index that device alone. A mesh and
    a device that disagree (another type, or an index the mesh does not
    hold throughout) raise ``ValueError``."""
    if mesh is None:
        if device is None or torch.device(device) == torch.device("cuda"):
            return make_mesh()
        return make_mesh(devices=[device])
    if device is not None:
        dev = torch.device(device)
        if dev.type != mesh.device_type or (
                dev.index is not None and any(d != dev for d in mesh.devices.flat)):
            raise ValueError(f"device {dev} disagrees with the mesh {mesh}")
    return mesh
