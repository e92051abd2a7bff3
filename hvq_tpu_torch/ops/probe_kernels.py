"""The TPU probe kernels on the card: build, ctypes binding, wrappers and
plain versions.

Three Pallas kernels in ``experiments/`` measure the TPU and lie on no path
of the system. Each has a hand-written Hopper kernel here, driven by a tool
of the experiment's name (``python -m hvq_tpu_torch.tools.<name>``):

* :func:`trivial` (``csrc/probes.cu``) replaces
  ``experiments/pallas_probe.py::_trivial``: o = 2·x;
* :func:`int8_probe` (``csrc/probes.cu``) replaces
  ``experiments/int8_probe.py::make_mosaic``: for each tile t,
  q·d[t] and the min over each 128 contiguous columns, bf16 or int8 on the
  tensor cores (:data:`INT8_PROBE_VARIANTS`);
* :func:`k1_anatomy` (``csrc/k1_anatomy.cu`` on the shared tensor-core body
  ``csrc/scan_wgmma.cuh``) replaces ``experiments/v3_anatomy.py::make_kernel``:
  K1 stopped at a stage (:data:`STAGES`) on an fp32, bf16 or int8 plane.

The sources build into a second library beside the engines' (``ops/kernels.py``,
whose sources and hash do not change): ``hvq_tpu_torch/_build/
libhvq_probes_<hash>.so``, keyed by a hash of these sources, the shared
header and the flags, at the first CUDA call of a wrapper here. nvcc runs
once per object, all at once: ``probes.cu``, and ``k1_anatomy.cu`` once per
plane. Importing this module builds nothing and needs no nvcc.

Each wrapper runs its plain PyTorch version (below) for tensors on the CPU
and launches its kernel for CUDA tensors, or raises: there is no fallback.
``launches`` counts kernel launches by variant, e.g.
``"k1_anatomy bf16 full R2"``, ``"int8_probe int8->i32"``, ``"trivial"``.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from hvq_tpu_torch.ops import kernels
from hvq_tpu_torch.ops.distance import dot_nt, mm_nt
from hvq_tpu_torch.ops.masks import block_mask
from hvq_tpu_torch.ops.scan import _PLAIN_CHUNK, scan_window
from hvq_tpu_torch.ops.topk import BIN, INF_KEY, KEY_MASK

_CSRC = kernels._PKG / "csrc"
# (source, extra nvcc flags): k1_anatomy.cu once per plane (its kPasses:
# 3 = fp32 plane, 1 = bf16 plane, 0 = int8 plane).
_SOURCES = (
    (_CSRC / "probes.cu", ()),
    *((_CSRC / "k1_anatomy.cu", (f"-DHVQ_ANATOMY_PLANE={p}",)) for p in (3, 1, 0)),
)

# The int8 plane of experiments/v3_anatomy.py (U[-6, 6] dimensions):
# x_i8 = clip(round(x · 127/6), −127, 127), q·d = int32 × (6/127)², both
# scales rounded to fp32 as the script's jnp arithmetic rounds them
# (csrc/scan_wgmma.cuh's kAlphaI8 is ALPHA_I8).
Q_SCALE_I8 = float(np.float32(127.0 / 6.0))
ALPHA_I8 = float(np.float32((6.0 / 127.0) ** 2))

# K1's stages, in csrc/scan_wgmma.cuh's Stage order; "mmc<CH>" (R = 1) is
# mm at db_tile = CH.
STAGES = ("mm", "mmb", "dist", "mask", "pack", "full")
PLANES = {torch.float32: "fp32", torch.bfloat16: "bf16", torch.int8: "int8"}
MAX_ANATOMY_R = 4

# experiments/int8_probe.py's Mosaic variants: (operand dtype, output
# dtype, csrc/probes.cu kind). int8 → f32 and int8 → i32 → f32 are the same
# kernel on the card: s8 wgmma accumulates in int32 only.
INT8_PROBE_VARIANTS = {
    "bf16->f32": (torch.bfloat16, torch.float32, 0),
    "int8->i32": (torch.int8, torch.int32, 1),
    "int8->i32->f32": (torch.int8, torch.float32, 2),
    "int8->f32": (torch.int8, torch.float32, 2),
}

# Kernel launches by variant, since import or the last reset_launches() (a
# plain dict, whose item update is cheaper than a Counter's on the launch path).
launches: dict = {}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def reset_launches() -> None:
    launches.clear()


_ANATOMY_ARGS = (
    [ctypes.c_int]                            # stage
    + [ctypes.c_void_p] * 12                  # V C T dn oid q qn ac v at l r
    + [ctypes.c_int] * 5                      # sn B n_pad db_tile R
    + [ctypes.c_void_p] * 2                   # out stream
)
_ENTRY_POINTS = {
    "hvq_probe_trivial": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p],
    "hvq_probe_mm": ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                     + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    **{f"hvq_k1_anatomy_{p}": _ANATOMY_ARGS for p in PLANES.values()},
}


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the probe library; idempotent
    (``build_info`` as ``kernels.build_library`` fills it). Locks only to
    build: once loaded, the library is read without the lock (as
    ``kernels.build``)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = kernels.build_library("libhvq_probes", _SOURCES, _ENTRY_POINTS,
                                             build_info)
    return _lib


# ----------------------------------------------------------------- trivial

def trivial_plain(x: torch.Tensor) -> torch.Tensor:
    """o = 2·x (exact in fp32)."""
    return x * 2.0


def trivial(x: torch.Tensor) -> torch.Tensor:
    """``experiments/pallas_probe.py::_trivial``: o = 2·x for a contiguous
    fp32 tensor. CPU tensors run :func:`trivial_plain`; CUDA tensors launch
    the kernel on the current stream. At the script's size the host's
    launch path is the time, so this one does only the checks, one
    allocation and the launch."""
    n = x.numel()
    if x.dtype is not torch.float32 or not x.is_contiguous() or n < 1:
        raise ValueError("trivial takes a non-empty contiguous fp32 tensor")
    if x.is_cpu:
        return trivial_plain(x)
    out = torch.empty_like(x)
    kernels.run("trivial", x.device, build().hvq_probe_trivial, x.data_ptr(), out.data_ptr(), n)
    launches["trivial"] = launches.get("trivial", 0) + 1
    return out


# -------------------------------------------------------------- int8 probe

def _probe_args(q, d, variant):
    if variant not in INT8_PROBE_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {tuple(INT8_PROBE_VARIANTS)}")
    dtype, out_dtype, _ = INT8_PROBE_VARIANTS[variant]
    for name, t, dim in (("q", q, 2), ("d", d, 3)):
        if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-D {dtype} tensor")
    B, K = q.shape
    nt, Kd, Dt = d.shape
    if K != BIN or Kd != BIN or Dt % BIN or q.device != d.device:
        raise ValueError("q (B, 128) and d (nt, 128, Dt), Dt a multiple of 128, "
                         "on one device")
    return B, nt, Dt, out_dtype


def int8_probe_plain(q: torch.Tensor, d: torch.Tensor, variant: str) -> torch.Tensor:
    """(nt, B, Dt/128): per tile t, q·d[t] in fp32 from exact products (bf16
    × bf16 is exact in fp32; the int8 sums are integers below 2²⁴, exact in
    any order), then the min over each 128 contiguous columns; int32 for
    ``"int8->i32"``."""
    B, nt, Dt, out_dtype = _probe_args(q, d, variant)
    out = torch.empty((nt, B, Dt // BIN), dtype=out_dtype, device=q.device)
    for t in range(nt):
        s = mm_nt(q, d[t].t())
        out[t] = s.view(B, Dt // BIN, BIN).amin(dim=2).to(out_dtype)
    return out


def int8_probe(q: torch.Tensor, d: torch.Tensor, variant: str,
               product: bool = True) -> torch.Tensor:
    """``experiments/int8_probe.py::make_mosaic`` (one ``variant``): q (B, 128)
    and d (nt, 128, Dt) bf16 or int8 → (nt, B, Dt/128), each tile's per-bin
    minima of q·d[t] (the script's ``run`` takes the min over tiles after).
    CPU tensors run :func:`int8_probe_plain`; CUDA tensors launch the
    kernel. ``product=False`` (int8 variants): everything but the product,
    to time the loads and the int8 path's transpose; its output is then
    the minima of zeros, not of q·d."""
    B, nt, Dt, out_dtype = _probe_args(q, d, variant)
    kind = INT8_PROBE_VARIANTS[variant][2]
    if not product and kind == 0:
        raise ValueError("product=False times the int8 transpose: int8 variants only")
    if q.device.type == "cpu":
        if not product:
            raise ValueError("product=False is a timing of the card's kernel")
        return int8_probe_plain(q, d, variant)
    out = torch.empty((nt, B, Dt // BIN), dtype=out_dtype, device=q.device)
    kernels.run("int8_probe", q.device, build().hvq_probe_mm, kind, int(product),
                q.data_ptr(), d.data_ptr(), out.data_ptr(), B, Dt, nt)
    key = f"int8_probe {variant}" + ("" if product else " transpose only")
    launches[key] = launches.get(key, 0) + 1
    return out


# -------------------------------------------------------------- K1 anatomy

def quantize_i8(x: torch.Tensor) -> torch.Tensor:
    """The int8 plane's quantization: clip(round(x · 127/6), −127, 127),
    round half to even (v3_anatomy.py:155-157, :237)."""
    return torch.clamp(torch.round(x.float() * Q_SCALE_I8), -127, 127).to(torch.int8)


def _qnorm(qV: torch.Tensor) -> torch.Tensor:
    return (qV * qV).sum(dim=1)


def anatomy_stage(stage: str, db_tile: int, bin_top: int, plane: str) -> tuple[str, int]:
    """(stage the kernel runs, its db_tile): a stage of :data:`STAGES` as it
    is; ``"mmc<CH>"`` (R = 1, the bf16 plane) as ``"mm"`` at db_tile = CH,
    the script's chunked product with each chunk's bins its own 128-way
    interleave. The script runs mmc on the bf16 plane only; on the others
    its chunked product is another function (one pass of the bf16 query
    against the fp32 rows; the int8 product without ALPHA_I8)."""
    if not 1 <= bin_top <= MAX_ANATOMY_R:
        raise ValueError(f"the anatomy takes R 1..{MAX_ANATOMY_R}, not {bin_top}")
    if stage in STAGES:
        return stage, db_tile
    if stage.startswith("mmc") and stage[3:].isdigit():
        ch = int(stage[3:])
        if bin_top != 1 or plane != "bf16" or ch % BIN or db_tile % ch:
            raise ValueError(f"{stage}: R = 1, the bf16 plane and chunks of 128·k "
                             f"rows dividing db_tile {db_tile}")
        return "mm", ch
    raise ValueError(f"unknown stage {stage!r}; one of {STAGES} or mmc<CH>")


def _anatomy_qd(qf: torch.Tensor, Vs: torch.Tensor) -> torch.Tensor:
    """(B, rows) q·d on the plane, as v3_anatomy.py:55-68 forms it: the
    3-pass bf16 split on the fp32 plane, one bf16 pass on the bf16 plane,
    the exact int8 product × ALPHA_I8 on the int8 plane."""
    if Vs.dtype == torch.int8:
        return mm_nt(quantize_i8(qf).float(), Vs.float()) * ALPHA_I8
    if Vs.dtype == torch.bfloat16:
        return dot_nt(qf, Vs.float(), "default")
    return dot_nt(qf, Vs, "high")


def k1_anatomy_plain(
    Vs, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
    stage: str = "full", db_tile: int = 16384, bin_top: int = 2,
):
    """Plain PyTorch version of the K1 anatomy (v3_anatomy.py:43-142) on the
    axis1 layout. Returns int32 (B, nt·R·bins), column tile·R·bins +
    j·bins + b: before ``pack`` the per-bin min's fp32 bits in entry 0 and
    zeros after; ``pack`` and ``full`` the R min rounds of the packed keys
    (``pack`` unmasked), as they are."""
    stage, db_tile = anatomy_stage(stage, db_tile, bin_top, PLANES[Vs.dtype])
    n_pad = Vs.shape[0]
    _, nt = scan_window(n_pad, db_tile, None, None)
    bins = db_tile // BIN
    B = qV.shape[0]
    qf = qV.float()
    qn = _qnorm(qf)
    s_iota = torch.arange(BIN, dtype=torch.int32, device=Vs.device).view(1, 1, BIN, 1)
    out = torch.zeros((B, nt, bin_top, bins), dtype=torch.int32, device=Vs.device)
    step = max(1, _PLAIN_CHUNK // max(1, B * db_tile))
    for c0 in range(0, nt, step):
        c1 = min(nt, c0 + step)
        rows = slice(c0 * db_tile, c1 * db_tile)
        shape = (B, c1 - c0, BIN, bins)
        qd = _anatomy_qd(qf, Vs[rows])
        if stage in ("mm", "mmb"):
            x = qd.to(torch.bfloat16).float() if stage == "mmb" else qd
            out[:, c0:c1, 0, :] = x.view(shape).amin(dim=2).view(torch.int32)
            continue
        dist = dn[rows][None, :] - 2.0 * qd + qn[:, None]
        del qd
        # `where`, not clamp: −0.0 would pack to a negative key
        dist = torch.where(dist > 0, dist, 0.0)
        if stage in ("mask", "full"):
            ok = block_mask(C[rows], T[rows], oid[rows], sn, active_c, v, active_t, l, r)
            dist = dist.masked_fill(~ok, float("inf"))
            del ok
        if stage in ("dist", "mask"):
            out[:, c0:c1, 0, :] = dist.view(shape).amin(dim=2).view(torch.int32)
            continue
        keys = (dist.view(torch.int32).view(shape) & KEY_MASK) | s_iota
        del dist
        for rnd in range(bin_top):
            m = keys.amin(dim=2)
            out[:, c0:c1, rnd, :] = m
            if rnd + 1 < bin_top:
                keys.masked_fill_(s_iota == (m & 0x7F).unsqueeze(2), INF_KEY)
        del keys
    return out.view(B, -1)


def k1_anatomy(
    Vs, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
    stage: str = "full", db_tile: int = 16384, bin_top: int = 2,
):
    """``experiments/v3_anatomy.py::make_kernel(stage, bin_top, plane)``:
    K1 stopped at ``stage`` (:data:`STAGES`, or ``"mmc<CH>"``). ``Vs`` is
    the scan plane, its dtype the plane: fp32 (3-pass bf16 split), bf16
    (one pass) or int8 (:func:`quantize_i8` of the fp32 rows; the queries
    are quantized the same way here, and ``dn`` holds the fp32 rows'
    norms). R = ``bin_top`` in 1..4. Returns int32 (B, nt·R·bins) as
    :func:`k1_anatomy_plain`. CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    device, n_pad, B = kernels._check_scan_args(
        Vs, tuple(PLANES), C, T, dn, oid, qV, active_c, v, active_t, l, r, bin_top)
    plane = PLANES[Vs.dtype]
    run_stage, tile = anatomy_stage(stage, db_tile, bin_top, plane)
    scan_window(n_pad, db_tile, None, None)
    if device.type == "cpu":
        return k1_anatomy_plain(Vs, C, T, dn, oid, qV, active_c, v, active_t, l, r, sn,
                                stage=stage, db_tile=db_tile, bin_top=bin_top)
    q = quantize_i8(qV) if plane == "int8" else qV
    if q.data_ptr() % 16:
        raise ValueError("qV must be 16-byte aligned")
    qn = _qnorm(qV)
    ac, at = active_c.to(torch.int32), active_t.to(torch.int32)
    out = torch.empty((B, n_pad // BIN * bin_top), dtype=torch.int32, device=device)
    kernels.run("k1_anatomy", device, getattr(build(), f"hvq_k1_anatomy_{plane}"),
                STAGES.index(run_stage), Vs.data_ptr(), C.data_ptr(), T.data_ptr(),
                dn.data_ptr(), oid.data_ptr(), q.data_ptr(), qn.data_ptr(), ac.data_ptr(),
                v.data_ptr(), at.data_ptr(), l.data_ptr(), r.data_ptr(), int(sn), B, n_pad,
                tile, bin_top, out.data_ptr())
    key = f"k1_anatomy {plane} {stage} R{bin_top}"
    launches[key] = launches.get(key, 0) + 1
    return out

