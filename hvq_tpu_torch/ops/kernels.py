"""Hand-written CUDA kernels: build, ctypes binding and wrappers.

The scans each replace a Pallas kernel of ``hvq_tpu/ops/pallas_scan.py``:

* K1 ``packed_scan_v3`` (``csrc/packed_scan_v3.cu``) — ``fused_packed_scan_v3``;
* K3 ``packed_scan``, K2 ``packed_scan_v2`` and K4 ``bin_scan``
  (``csrc/lane_scan.cu``) — ``fused_packed_scan``, ``fused_packed_scan_v2``
  and ``fused_bin_scan``.

The level-2 select ``level2_select`` (``csrc/level2_select.cu``) replaces
none: it is the kernel of the reduce the JAX package writes in ``jnp``
(``hvq_tpu/ops/topk.py`` ``binned_stream_topk``).

K1, K3, K2 and K4 share one tensor-core body (``csrc/scan_wgmma.cuh``,
which both scan sources include) for ``bin_top`` ≤ 8 and keep a CUDA-core
body above: dispatch on shape, both built and checked.

The sources are compiled with ``nvcc`` for ``sm_90a``, one process per
source in parallel, and linked into one shared library with a plain C
interface, at first CUDA use, into ``hvq_tpu_torch/_build/`` keyed by a
hash of the sources, the header and the flags. Importing this module
builds nothing and needs no ``nvcc``.

Each wrapper runs its kernel's plain PyTorch version (in ``ops/scan.py``;
the select's in ``ops/topk.py``) for tensors on the CPU and launches the
kernel for CUDA tensors, or raises: there is no fallback. ``launches``
counts kernel launches only; ``k1_body_launches`` splits K1's by body,
``lane_body_launches`` K3's, K2's and K4's and ``level2_body_launches`` the
select's (the library says which body runs). Every launch goes through
:func:`run`, kept thin: at small shapes the host's launch path, not the
kernel, sets the time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from hvq_tpu_torch.ops.scan import (
    bin_scan_plain,
    check_bin_top,
    packed_scan_plain,
    scan_window,
)
from hvq_tpu_torch.ops.topk import BIN, level2_select_plain
from hvq_tpu_torch.utils import timing
from hvq_tpu_torch.utils.timing import current_device as _current_device
from hvq_tpu_torch.utils.timing import raw_stream as _raw_stream

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (
    _PKG / "csrc" / "packed_scan_v3.cu",
    _PKG / "csrc" / "lane_scan.cu",
    _PKG / "csrc" / "level2_select.cu",
)
# Included by both scan sources: the tensor-core body of K1, K3, K2 and K4.
_HEADERS = (_PKG / "csrc" / "scan_wgmma.cuh",)
BUILD_DIR = _PKG / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Where nvcc is looked for after PATH and $CUDA_HOME / $CUDA_PATH.
CUDA_ROOTS = ("/usr/local/cuda",)

# Kernel launches by wrapper name, since import or the last reset().
launches = {"packed_scan_v3": 0, "packed_scan": 0, "packed_scan_v2": 0,
            "bin_scan": 0, "level2_select": 0}
# K1's launches by body (csrc/packed_scan_v3.cu): the tensor-core body for
# bin_top ≤ 8, the CUDA-core body above; the library says which runs.
k1_body_launches = {"wgmma": 0, "simt": 0}
_BODIES = ("wgmma", "simt")
# K3's, K2's and K4's launches by body (csrc/lane_scan.cu), as K1's.
lane_body_launches = {name: {"wgmma": 0, "simt": 0}
                      for name in ("packed_scan", "packed_scan_v2", "bin_scan")}
# The level-2 select's launches by body (csrc/level2_select.cu): its keys in
# registers for rounds ≤ 16, in shared memory above.
level2_body_launches = {"registers": 0, "shared": 0}
_LEVEL2_BODIES = ("registers", "shared")

# ``mode`` of the C entry point hvq_lane_scan for each lane-layout kernel.
_LANE_MODES = {"packed_scan": 0, "packed_scan_v2": 1, "bin_scan": 2}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def reset_launches() -> None:
    for counts in (launches, k1_body_launches, level2_body_launches,
                   *lane_body_launches.values()):
        for name in counts:
            counts[name] = 0


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


def _jobs(sources) -> list:
    """(path, extra nvcc flags) of each source: a path, or (path, flags) to
    compile one file more than once."""
    return [s if isinstance(s, tuple) else (s, ()) for s in sources]


def _source_hash(sources=_SOURCES, headers=_HEADERS) -> str:
    """The library's key: each file's name and bytes, the flags, and any
    per-source extra flags."""
    jobs = _jobs(sources)
    h = hashlib.sha256()
    for src in dict.fromkeys([src for src, _ in jobs] + list(headers)):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    for src, flags in jobs:
        if flags:
            h.update(f"{src.name} {' '.join(flags)}".encode())
    return h.hexdigest()[:16]


def _compile(nvcc: str, tmp: Path, sources=_SOURCES) -> tuple[float, str]:
    """nvcc every source to an object, all at once, then link one library
    at ``tmp``. A source is a path, or (path, extra nvcc flags) to compile
    one file more than once. Returns (seconds, compiler output)."""
    t0 = time.perf_counter()
    jobs = _jobs(sources)
    objs = [tmp.with_name(f"{tmp.stem}.{i}.{src.stem}.o")
            for i, (src, _) in enumerate(jobs)]
    cmds = [[nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(o), str(src)]
            for (src, flags), o in zip(jobs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(outs)
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}"
            )
    link = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(link, capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    return time.perf_counter() - t0, log


def build_library(stem: str, sources, entry_points: dict, info: dict) -> ctypes.CDLL:
    """Compile (if needed) and load the library ``<stem>_<hash>.so`` of
    ``sources`` in BUILD_DIR, declaring ``entry_points`` (name → argtypes).
    ``info`` receives the library path, whether this call compiled, the
    compile seconds and nvcc's ptxas report (registers, spills)."""
    so = BUILD_DIR / f"{stem}_{_source_hash(sources)}.so"
    compiled, seconds, log = False, 0.0, ""
    if not so.exists():
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        seconds, log = _compile(nvcc, tmp, sources)
        os.replace(tmp, so)
        compiled = True
    info.update(path=str(so), compiled=compiled, seconds=seconds, log=log)
    return _load(so, tuple(entry_points), entry_points)


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; idempotent
    (``build_info`` as :func:`build_library` fills it). Every launch calls
    it, so it locks only to build: once loaded, the library is read without
    the lock. Its entry points were declared once at load (:func:`_load`),
    and ctypes keeps each as an attribute of the library."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = build_library("libhvq_kernels", _SOURCES, _ENTRY_POINTS, build_info)
    return _lib


# Each C entry point's argument types (all return an int).
_ENTRY_POINTS = {
    "hvq_packed_scan_v3": (
        [ctypes.c_void_p, ctypes.c_int]          # V, v_bf16
        + [ctypes.c_void_p] * 11                  # C T dn oid q qn ac v at l r
        + [ctypes.c_int] * 7                      # sn B n_pad db_tile R t0 ntw
        + [ctypes.c_void_p] * 3                   # out_d out_p stream
    ),
    "hvq_packed_scan_v3_counted": (
        [ctypes.c_void_p, ctypes.c_int]          # V, v_bf16
        + [ctypes.c_void_p] * 11                  # C T dn oid q qn ac v at l r
        + [ctypes.c_int] * 7                      # sn B n_pad db_tile R t0 ntw
        + [ctypes.c_void_p] * 4                   # out_d out_p open_wg stream
    ),
    "hvq_packed_scan_v3_body": [ctypes.c_int],   # R
    "hvq_packed_scan_v3_warpgroups": [ctypes.c_int] * 5,   # v_bf16 B db_tile ntw R
    "hvq_lane_scan": (
        [ctypes.c_int]                            # mode
        + [ctypes.c_void_p] * 12                  # V C T dn oid q qn ac v at l r
        + [ctypes.c_int] * 5                      # sn B n_pad db_tile R
        + [ctypes.c_void_p] * 3                   # out_d out_i stream
    ),
    "hvq_lane_scan_body": [ctypes.c_int, ctypes.c_int],   # mode, R
    "hvq_level2_select": (
        [ctypes.c_void_p]                         # s
        + [ctypes.c_int] * 5                      # B W rounds ls bs
        + [ctypes.c_void_p] * 4                   # d2 col worst2 stream
    ),
    "hvq_level2_select_body": [ctypes.c_int],    # rounds
}


def _load(so: Path, entries=tuple(_ENTRY_POINTS), argtypes=_ENTRY_POINTS) -> ctypes.CDLL:
    """Load a kernel library and declare its C entry points ``entries``
    (each returns an int; ``argtypes`` by name)."""
    lib = ctypes.CDLL(str(so))
    for name in entries:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes[name]
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


def _check_scan_args(Vs, planes, C, T, dn, oid, qV, active_c, v, active_t,
                     l, r, bin_top):
    """Device, dtype, shape and contiguity checks shared by the wrappers;
    returns (device, n_pad, B)."""
    device = Vs.device
    n_pad = Vs.shape[0] if Vs.dim() == 2 else -1
    B = qV.shape[0] if qV.dim() == 2 else -1
    f32, i32, b = (torch.float32,), (torch.int32,), (torch.bool,)
    _check("Vs", Vs, planes, (n_pad, BIN), device)
    for name, t in (("C", C), ("T", T), ("dn", dn)):
        _check(name, t, f32, (n_pad,), device)
    _check("oid", oid, i32, (n_pad,), device)
    _check("qV", qV, f32, (B, BIN), device)
    for name, t in (("active_c", active_c), ("active_t", active_t)):
        _check(name, t, b, (B,), device)
    for name, t in (("v", v), ("l", l), ("r", r)):
        _check(name, t, f32, (B,), device)
    check_bin_top(bin_top)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the scan kernels run on cpu or cuda, not {device}")
    if device.type == "cuda":
        if Vs.data_ptr() % 16:
            raise ValueError("Vs must be 16-byte aligned")
        if n_pad >= 2 ** 31:
            raise ValueError("scan too large for int32 row positions")
    return device, n_pad, B


def _launch(name, device, B, W, qV, active_c, active_t, call):
    """Run kernel ``name`` on the device's current stream: derives its
    query inputs, allocates its (B, W) fp32 and int32 outputs, passes
    ``call(qn, ac, at, out_d, out_i, stream)`` their pointers through
    :func:`run` and counts the launch."""
    qn = (qV * qV).sum(dim=1)
    ac = active_c.to(torch.int32)
    at = active_t.to(torch.int32)
    out_d = torch.empty((B, W), dtype=torch.float32, device=device)
    out_i = torch.empty((B, W), dtype=torch.int32, device=device)
    run(name, device, call, qn.data_ptr(), ac.data_ptr(), at.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr())
    launches[name] += 1
    return out_d, out_i




def run(name: str, device: torch.device, fn, *args) -> None:
    """``fn(*args, stream)`` on the caller's current stream of ``device``,
    with ``device`` current: a device guard is entered only when another
    device is. Raises on the C entry's error (a cudaError_t, or −CUresult
    when a tensor map cannot be encoded)."""
    index, current = device.index, _current_device()
    if index is None or index == current:
        err = fn(*args, _raw_stream(current))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err:
        raise RuntimeError(f"{name} launch failed: " + (
            f"cudaError {err}" if err > 0 else f"tensor map encode, CUresult {-err}"))


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
    the kernel: its tensor-core body for ``bin_top`` ≤ 8, its CUDA-core body
    above (counted apart in ``k1_body_launches``). Under an active tracer
    (``utils.timing.recording``) each call counts a ``k1_launch`` with its
    B, rows, W and plane bytes, on either device; on a card also with
    ``warpgroups``, the tensor-core body's warpgroups that hold queries
    (⌈B/64⌉ a bin block of each tile), and ``open_warpgroups``, those of
    them that ran the predicate-free epilogue: a count the kernel keeps
    on the card, read at the tracer's ``export()``.
    """
    device, n_pad, B = _check_scan_args(
        Vs, (torch.float32, torch.bfloat16), C, T, dn, oid, qV, active_c, v,
        active_t, l, r, bin_top)
    t0, nt = scan_window(n_pad, db_tile, row0, ntw)
    sn = int(sn)
    W = nt * bin_top * (db_tile // BIN)
    bf16 = int(Vs.dtype == torch.bfloat16)
    tracer = timing.active_tracer
    # the launch log: the rows scanned (a window's or the plane's) and the
    # width of the (B, W) output
    log = None if tracer is None else dict(
        kernel="packed_scan_v3", B=B, rows=ntw * db_tile if ntw else n_pad, W=W,
        plane_bytes=Vs.element_size())
    if device.type == "cpu":
        if log is not None:
            tracer.count("k1_launch", **log)
        return packed_scan_plain(
            Vs, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
            db_tile=db_tile, bin_top=bin_top, row0=row0, ntw=ntw,
        )
    if qV.data_ptr() % 16:             # read as float4s
        raise ValueError("qV must be 16-byte aligned")
    lib = build()
    fn, counted = lib.hvq_packed_scan_v3, ()
    if log is not None:
        open_wg = torch.zeros(1, dtype=torch.int32, device=device)
        fn, counted = lib.hvq_packed_scan_v3_counted, (open_wg.data_ptr(),)
        tracer.count("k1_launch", **log, open_warpgroups=open_wg,
                     warpgroups=lib.hvq_packed_scan_v3_warpgroups(
                         bf16, B, db_tile, nt, bin_top))
    out = _launch(
        "packed_scan_v3", device, B, W, qV,
        active_c, active_t,
        lambda qn, ac, at, out_d, out_p, stream: fn(
            Vs.data_ptr(), bf16,
            C.data_ptr(), T.data_ptr(), dn.data_ptr(), oid.data_ptr(),
            qV.data_ptr(), qn, ac, v.data_ptr(), at, l.data_ptr(),
            r.data_ptr(), sn, B, n_pad, db_tile, bin_top, t0, nt, out_d,
            out_p, *counted, stream,
        ),
    )
    k1_body_launches[_BODIES[lib.hvq_packed_scan_v3_body(bin_top)]] += 1
    return out


def _lane_scan(name, Vp, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
               db_tile, bin_top):
    """Checks, then ``plain[name]`` on CPU tensors or the kernel ``name`` of
    ``csrc/lane_scan.cu`` on CUDA tensors. ``Vp`` is the fp32 plane."""
    device, n_pad, B = _check_scan_args(
        Vp, (torch.float32,), C, T, dn, oid, qV, active_c, v, active_t, l, r,
        bin_top)
    _, nt = scan_window(n_pad, db_tile, None, None)
    sn = int(sn)
    if device.type == "cpu":
        return plain[name](Vp, C, T, dn, oid, qV, active_c, v, active_t, l, r,
                           sn, db_tile=db_tile, bin_top=bin_top)
    if qV.data_ptr() % 16:             # read as float4s
        raise ValueError("qV must be 16-byte aligned")
    lib = build()
    fn, mode = lib.hvq_lane_scan, _LANE_MODES[name]
    out = _launch(
        name, device, B, nt * bin_top * (db_tile // BIN), qV, active_c,
        active_t,
        lambda qn, ac, at, out_d, out_i, stream: fn(
            mode, Vp.data_ptr(), C.data_ptr(), T.data_ptr(),
            dn.data_ptr(), oid.data_ptr(), qV.data_ptr(), qn, ac,
            v.data_ptr(), at, l.data_ptr(), r.data_ptr(), sn, B, n_pad,
            db_tile, bin_top, out_d, out_i, stream,
        ),
    )
    lane_body_launches[name][_BODIES[lib.hvq_lane_scan_body(mode, bin_top)]] += 1
    return out


def packed_scan(
    Vp, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
    db_tile: int = 8192,
    bin_top: int = 2,
):
    """K3: the lane-layout packed scan, output contract of
    ``fused_packed_scan``.

    Bin b of a tile is its 128 contiguous rows b·128 + lane. Returns (dist
    (B, W) fp32 [low 7 bits zeroed, +inf = empty], pos (B, W) int32 =
    tile·Dt + b·128 + lane), W = nt · bin_top · db_tile/128. ``Vp`` is the
    fp32 plane. CPU tensors run ``packed_scan_plain(layout="lane",
    precision="highest")`` (IEEE fp32, what the JAX package computes on a
    CPU); CUDA tensors launch the kernel: for ``bin_top`` ≤ 8 its
    tensor-core body, q·d as the TPU kernel forms it (``Precision.HIGH``,
    which Mosaic runs as the 6-pass bf16 emulation of fp32: each operand
    split into three bf16 parts, six products chained smallest first into
    one fp32 accumulator), above it the CUDA-core body in IEEE fp32 FMAs
    (counted apart in ``lane_body_launches``). Both stay within the
    certificate's fp32 slack of the plain version.
    """
    return _lane_scan("packed_scan", Vp, C, T, dn, oid, qV, active_c, v,
                      active_t, l, r, sn, db_tile, bin_top)


def packed_scan_v2(
    Vp, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
    db_tile: int = 8192,
    bin_top: int = 2,
):
    """K2: the lane-layout packed scan with the 3-pass bf16 split
    ``q_hi·d_hi + q_hi·d_lo + q_lo·d_hi``, output contract of
    ``fused_packed_scan_v2`` (as :func:`packed_scan`). CPU tensors run
    ``packed_scan_plain(layout="lane", precision="high")``; CUDA tensors
    launch the kernel: for ``bin_top`` ≤ 8 its tensor-core body (K1's
    fp32-plane chain, three wgmma passes into one fp32 accumulator), above
    it the CUDA-core body (three fp32 accumulators of the same split;
    counted apart in ``lane_body_launches``).
    """
    return _lane_scan("packed_scan_v2", Vp, C, T, dn, oid, qV, active_c, v,
                      active_t, l, r, sn, db_tile, bin_top)


def bin_scan(
    Vp, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
    db_tile: int = 2048,
    bin_top: int = 2,
):
    """K4: the unpacked lane-layout bin scan, output contract of
    ``fused_bin_scan``: (scores (B, W) fp32 = ‖d‖² − 2·q·d, +inf where
    masked or empty, ids (B, W) int32 = ``oid`` of the row, or of the
    bin's lane 0 for padding). CPU tensors run :func:`bin_scan_plain`
    (q·d in IEEE fp32, what the JAX package computes on a CPU); CUDA tensors
    launch the kernel: for ``bin_top`` ≤ 8 the tensor-core body K3 runs,
    q·d as the TPU kernel forms it (``Precision.HIGHEST``, the 6-pass bf16
    emulation of fp32 chained smallest first into one fp32 accumulator) and
    an (fp32 score, lane) pair an entry; above it the CUDA-core body in IEEE
    fp32 FMAs (counted apart in ``lane_body_launches``). Both stay within
    the certificate's fp32 slack of the plain version; ties go to the
    lowest lane in all three.
    """
    return _lane_scan("bin_scan", Vp, C, T, dn, oid, qV, active_c, v,
                      active_t, l, r, sn, db_tile, bin_top)


def level2_select(out_s, rounds: int, layout: str = "axis1"):
    """The level-2 select: each 128-member bin of the (B, W) fp32 stream
    ``out_s`` reduced to its best ``rounds`` packed keys, output contract of
    :func:`~hvq_tpu_torch.ops.topk.level2_select_plain` bit for bit (d2,
    col, worst2; bins2 = ⌈W/128⌉ bins, ``layout`` "axis1" or "lane").

    CPU tensors run the plain version; CUDA tensors launch the kernel, read
    in place (no packed or padded copy): its register body for ``rounds`` ≤
    16, its shared-memory body above (counted apart in
    ``level2_body_launches``). Under an active tracer
    (``utils.timing.recording``) each call counts a ``level2_select`` with
    its B, W, rounds, layout and body ("plain" on the CPU).
    """
    if layout not in ("axis1", "lane"):
        raise ValueError(f"layout must be 'axis1' or 'lane', not {layout!r}")
    if not 1 <= rounds <= BIN:
        raise ValueError(f"rounds must be in [1, {BIN}], got {rounds}")
    if not isinstance(out_s, torch.Tensor) or out_s.dim() != 2:
        raise ValueError("out_s must be a (B, W) tensor")
    device = out_s.device
    B, W = out_s.shape
    _check("out_s", out_s, (torch.float32,), (B, W), device)
    if device.type == "cpu":
        _count_level2(B, W, rounds, layout, "plain")
        return level2_select_plain(out_s, rounds, layout)
    if device.type != "cuda":
        raise ValueError(f"the level-2 select runs on cpu or cuda, not {device}")
    bins2 = -(-W // BIN)
    lane_stride, bin_stride = (bins2, 1) if layout == "axis1" else (1, BIN)
    d2 = torch.empty((B, rounds * bins2), dtype=torch.float32, device=device)
    col = torch.empty((B, rounds * bins2), dtype=torch.int32, device=device)
    worst2 = torch.empty((B,), dtype=torch.float32, device=device)
    lib = build()
    run("level2_select", device, lib.hvq_level2_select, out_s.data_ptr(), B, W,
        rounds, lane_stride, bin_stride, d2.data_ptr(), col.data_ptr(),
        worst2.data_ptr())
    launches["level2_select"] += 1
    body = _LEVEL2_BODIES[lib.hvq_level2_select_body(rounds)]
    level2_body_launches[body] += 1
    _count_level2(B, W, rounds, layout, body)
    return d2, col, worst2


def _count_level2(B, W, rounds, layout, body):
    tracer = timing.active_tracer
    if tracer is not None:
        tracer.count("level2_select", B=B, W=W, rounds=rounds, layout=layout,
                     body=body)


# Each wrapper's plain PyTorch version: what it runs on CPU tensors, and
# what a kernel is held against on the card.
plain = {
    "packed_scan_v3": packed_scan_plain,
    "packed_scan": functools.partial(packed_scan_plain, layout="lane",
                                     precision="highest"),
    "packed_scan_v2": functools.partial(packed_scan_plain, layout="lane",
                                        precision="high"),
    "bin_scan": bin_scan_plain,
    "level2_select": level2_select_plain,
}
