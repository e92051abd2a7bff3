"""Device-resident database layout: the counterpart of
``hvq_tpu.models.device_db``.

* ``Vp``      (n_pad, 128) fp32 — vectors zero-padded from 100 to 128 lanes,
* ``C``, ``T`` (n_pad,) fp32   — categorical and timestamp attributes,
* ``d_norms`` (n_pad,) fp32    — ‖d‖², computed on the device from ``Vp``,
* ``V_scan``  (n_pad, 128) bf16, optional — the scan plane that only the
  selection scan reads; refinement keeps gathering exact fp32 ``Vp`` rows.

Rows are padded to a multiple of the database tile; padding rows are
masked by the ``id < sn`` term of the predicate. Host arrays reach the
device through pinned memory on a CUDA device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hvq_tpu_torch import constants as _c
from hvq_tpu_torch.utils.formats import Dataset


def resolve_device(device: torch.device | str) -> torch.device:
    """The device with its index spelled out ("cuda" → "cuda:<current>").

    Engines and views default to ``"cuda"``; without a card that raises
    here, never falls back: the CPU runs only when asked (``device="cpu"``).
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' (the default) needs an NVIDIA GPU and a CUDA "
                "build of torch; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def upload(host: np.ndarray | torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host array → device tensor, through a pinned buffer on CUDA."""
    if isinstance(host, np.ndarray):
        if not host.flags.writeable:       # e.g. a view of another engine's
            host = host.copy()             # buffer; torch wants to own it
        host = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return host.to(device)
    if not host.is_pinned():
        host = host.pin_memory()
    out = host.to(device, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()   # the buffer may go now
    return out


def upload_async(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """Small host array → device tensor without waiting for the device: a
    pinned copy whose buffer PyTorch's host allocator keeps until the copy
    has run, so dispatches can be enqueued back to back."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class PinnedStaging:
    """One reusable host buffer of ``rows`` × ``cols`` fp32 for large
    host → device copies, pinned when it is bound for a CUDA device.

    :meth:`upload` copies a host slab (a slice of an ``np.memmap`` too)
    into the buffer once and starts the device copy without waiting for
    it. Before the buffer is written again, the next call waits on an
    event recorded after the last copy, so a copy never reads a buffer
    that is being overwritten. The buffer is allocated at first use.
    """

    def __init__(self, rows: int, cols: int, device: torch.device):
        self.shape = (int(rows), int(cols))
        self.device = device
        self._buf: torch.Tensor | None = None
        self._copied: torch.cuda.Event | None = None

    def upload(self, host: np.ndarray) -> torch.Tensor:
        """(r, cols) host rows → a (r, cols) fp32 device tensor."""
        r = host.shape[0]
        if r > self.shape[0] or host.shape[1:] != self.shape[1:]:
            raise ValueError(f"{host.shape} does not fit the staging buffer {self.shape}")
        if self.device.type != "cuda":
            return torch.from_numpy(np.array(host, np.float32))
        if self._buf is None:
            self._buf = torch.empty(self.shape, dtype=torch.float32, pin_memory=True)
        if self._copied is not None:
            self._copied.synchronize()      # the last copy has read the buffer
        stage = self._buf[:r]
        stage.numpy()[:] = host
        out = stage.to(self.device, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(self.device))
        return out


def upload_scan_plane(V_scan, shape: tuple, device: torch.device) -> torch.Tensor:
    """A bf16 scan plane carried over from arrays: any dtype that converts
    to fp32 exactly (bfloat16, or bf16-valued fp32), stored as bf16."""
    v32 = torch.from_numpy(np.ascontiguousarray(V_scan, np.float32))
    if tuple(v32.shape) != tuple(shape):
        raise ValueError(f"V_scan must be {tuple(shape)}, got {tuple(v32.shape)}")
    v16 = v32.to(torch.bfloat16)
    if not torch.equal(v16.float(), v32):
        raise ValueError("V_scan holds values that bf16 cannot represent")
    return upload(v16, device)


def _host_zeros(shape, device: torch.device) -> torch.Tensor:
    """Zeroed fp32 host buffer, pinned when it is bound for a CUDA device."""
    return torch.zeros(shape, dtype=torch.float32,
                       pin_memory=device.type == "cuda")


@dataclasses.dataclass
class DeviceDB:
    Vp: torch.Tensor        # (n_pad, 128) fp32
    C: torch.Tensor         # (n_pad,) fp32
    T: torch.Tensor         # (n_pad,) fp32
    d_norms: torch.Tensor   # (n_pad,) fp32
    n: int                  # true row count
    db_tile: int
    V_scan: Optional[torch.Tensor] = None   # (n_pad, 128) bf16 scan plane

    @property
    def n_pad(self) -> int:
        return self.Vp.shape[0]

    @property
    def num_tiles(self) -> int:
        return self.n_pad // self.db_tile

    @property
    def device(self) -> torch.device:
        return self.Vp.device

    @property
    def scan_V(self) -> torch.Tensor:
        """The plane the selection scan reads (bf16 if present, else Vp)."""
        return self.V_scan if self.V_scan is not None else self.Vp

    @classmethod
    def from_dataset(
        cls,
        ds: Dataset,
        db_tile: int = 16384,
        scan_store: str = "fp32",
        device: torch.device | str = "cuda",
        row_multiple: int | None = None,
    ) -> "DeviceDB":
        """Upload a host Dataset, lane-padding columns and tile-padding rows.

        ``scan_store="bf16"`` also keeps a bf16 copy for the selection scan,
        rounded on the device. ``row_multiple`` (default ``db_tile``) pads
        the rows to its multiple instead: the mesh engines need
        ``n_d · db_tile``, so every shard holds whole tiles.
        """
        if scan_store not in ("fp32", "bf16"):
            raise ValueError(f"unknown scan_store {scan_store!r}")
        mult = row_multiple or db_tile
        if mult % db_tile:
            raise ValueError("row_multiple must be a multiple of db_tile")
        device = resolve_device(device)
        n = ds.n
        n_pad = -(-n // mult) * mult
        # one padded host buffer per column, filled in place
        Vp = _host_zeros((n_pad, _c.PADDED_DIM), device)
        Vp.numpy()[:n, : ds.V.shape[1]] = ds.V
        C = _host_zeros(n_pad, device)
        C.numpy()[:n] = ds.C
        T = _host_zeros(n_pad, device)
        T.numpy()[:n] = ds.T
        Vp_dev = upload(Vp, device)
        del Vp
        return cls(
            Vp=Vp_dev,
            C=upload(C, device),
            T=upload(T, device),
            d_norms=(Vp_dev * Vp_dev).sum(dim=1),
            n=n,
            db_tile=db_tile,
            V_scan=Vp_dev.to(torch.bfloat16) if scan_store == "bf16" else None,
        )

    @classmethod
    def from_arrays(
        cls,
        Vp: np.ndarray,
        C: np.ndarray,
        T: np.ndarray,
        d_norms: np.ndarray,
        n: int,
        db_tile: int,
        V_scan: np.ndarray | None = None,
        device: torch.device | str = "cuda",
    ) -> "DeviceDB":
        """A database from arrays another engine already laid out.

        E.g. ``np.asarray(jax_db.Vp)``: the JAX ``DeviceDB``'s own padded
        rows, device-computed ``d_norms`` and bf16 ``V_scan`` carry over
        unchanged, so both packages search identical stored state.
        ``V_scan`` may be any dtype that converts to fp32 exactly
        (bfloat16 or bf16-valued fp32); it is stored as bf16.
        """
        device = resolve_device(device)
        Vp = np.asarray(Vp, np.float32)
        if Vp.ndim != 2 or Vp.shape[1] != _c.PADDED_DIM:
            raise ValueError(f"Vp must be (n_pad, {_c.PADDED_DIM}), got {Vp.shape}")
        n_pad = Vp.shape[0]
        if n_pad % db_tile or not 0 < n <= n_pad:
            raise ValueError(f"n_pad {n_pad} must cover n {n} in {db_tile}-row tiles")
        cols = [np.asarray(x, np.float32) for x in (C, T, d_norms)]
        if any(x.shape != (n_pad,) for x in cols):
            raise ValueError(f"C, T, d_norms must be ({n_pad},)")
        scan = None
        if V_scan is not None:
            scan = upload_scan_plane(V_scan, Vp.shape, device)
        C_dev, T_dev, dn_dev = (upload(x, device) for x in cols)
        return cls(
            Vp=upload(Vp, device), C=C_dev, T=T_dev, d_norms=dn_dev, n=int(n),
            db_tile=int(db_tile), V_scan=scan,
        )
