"""Hand-written CUDA kernels: build, ctypes binding and wrappers.

K1, the packed bin scan (``csrc/packed_scan_v3.cu``), replaces the Pallas
kernel ``hvq_tpu/ops/pallas_scan.py::fused_packed_scan_v3``. Its sources
are compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface, at first CUDA use, into ``hvq_tpu_torch/_build/`` keyed
by a hash of the sources. Importing this module builds nothing and needs
no ``nvcc``.

Each wrapper runs its kernel's plain PyTorch version (in ``ops/scan.py``)
for tensors on the CPU and launches the kernel for CUDA tensors, or
raises: there is no fallback. ``launches`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from hvq_tpu_torch.ops.scan import packed_scan_plain, scan_window
from hvq_tpu_torch.ops.topk import BIN

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "packed_scan_v3.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Where nvcc is looked for after PATH and $CUDA_HOME / $CUDA_PATH.
CUDA_ROOTS = ("/usr/local/cuda",)

# Kernel launches by wrapper name, since import or the last reset().
launches = {"packed_scan_v3": 0}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc_path() -> str:
    """The nvcc executable: PATH, then $CUDA_HOME / $CUDA_PATH, then CUDA_ROOTS."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in (home, *CUDA_ROOTS):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        f"nvcc not found (PATH, CUDA_HOME, {', '.join(CUDA_ROOTS)}): the CUDA "
        "kernels of hvq_tpu_torch are built from source at first use"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for src in _SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; idempotent.

    ``build_info`` records the library path, whether this call compiled,
    the compile seconds and ``nvcc``'s ptxas report (registers, spills).
    """
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = BUILD_DIR / f"libhvq_kernels_{_source_hash()}.so"
        compiled, seconds, log = False, 0.0, ""
        if not so.exists():
            nvcc = nvcc_path()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
                )
            os.replace(tmp, so)
            compiled = True
        lib = ctypes.CDLL(str(so))
        fn = lib.hvq_packed_scan_v3
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int]          # V, v_bf16
            + [ctypes.c_void_p] * 11                  # C T dn oid q qn ac v at l r
            + [ctypes.c_int] * 6                      # sn B db_tile R t0 ntw
            + [ctypes.c_void_p] * 3                   # out_d out_p stream
        )
        build_info.update(path=str(so), compiled=compiled, seconds=seconds,
                          log=log)
        _lib = lib
        return lib


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def packed_scan_v3(
    Vs, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
    db_tile: int = 16384,
    bin_top: int = 2,
    row0=None,
    ntw: int | None = None,
):
    """K1: the packed bin scan, output contract of ``fused_packed_scan_v3``.

    Returns (dist (B, W) fp32 [low 7 bits zeroed, +inf = empty], pos
    (B, W) int32 global row positions), W = nt · bin_top · db_tile/128,
    nt = n_pad/db_tile or ``ntw`` for a window starting at the
    tile-aligned ``row0``. ``Vs`` is the scan plane: (n_pad, 128) fp32 or
    bf16. CPU tensors run :func:`packed_scan_plain`; CUDA tensors launch
    the kernel.
    """
    device = Vs.device
    n_pad = Vs.shape[0] if Vs.dim() == 2 else -1
    B = qV.shape[0] if qV.dim() == 2 else -1
    f32, i32, b = (torch.float32,), (torch.int32,), (torch.bool,)
    _check("Vs", Vs, (torch.float32, torch.bfloat16), (n_pad, BIN), device)
    for name, t in (("C", C), ("T", T), ("dn", dn)):
        _check(name, t, f32, (n_pad,), device)
    _check("oid", oid, i32, (n_pad,), device)
    _check("qV", qV, f32, (B, BIN), device)
    for name, t in (("active_c", active_c), ("active_t", active_t)):
        _check(name, t, b, (B,), device)
    for name, t in (("v", v), ("l", l), ("r", r)):
        _check(name, t, f32, (B,), device)
    t0, nt = scan_window(n_pad, db_tile, row0, ntw)
    if not 1 <= bin_top <= BIN:
        raise ValueError(f"bin_top {bin_top} outside [1, {BIN}]")
    sn = int(sn)
    if device.type == "cpu":
        return packed_scan_plain(
            Vs, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
            db_tile=db_tile, bin_top=bin_top, row0=row0, ntw=ntw,
        )
    if device.type != "cuda":
        raise ValueError(f"packed_scan_v3 runs on cpu or cuda, not {device}")
    if Vs.data_ptr() % 16:
        raise ValueError("Vs must be 16-byte aligned")
    if n_pad >= 2 ** 31:
        raise ValueError("scan too large for int32 row positions")
    fn = build().hvq_packed_scan_v3
    W = nt * bin_top * (db_tile // BIN)
    qn = (qV * qV).sum(dim=1)
    ac = active_c.to(torch.int32)
    at = active_t.to(torch.int32)
    out_d = torch.empty((B, W), dtype=torch.float32, device=device)
    out_p = torch.empty((B, W), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            Vs.data_ptr(), int(Vs.dtype == torch.bfloat16),
            C.data_ptr(), T.data_ptr(), dn.data_ptr(), oid.data_ptr(),
            qV.data_ptr(), qn.data_ptr(), ac.data_ptr(), v.data_ptr(),
            at.data_ptr(), l.data_ptr(), r.data_ptr(),
            sn, B, db_tile, bin_top, t0, nt,
            out_d.data_ptr(), out_p.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"packed_scan_v3 launch failed: cudaError {err}")
    launches["packed_scan_v3"] += 1
    return out_d, out_p
