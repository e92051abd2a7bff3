"""ctypes bindings of the port's C++ host runtime (``hvq_native.cpp``).

The port's own copy of the JAX package's ``hvq_tpu.native``, with its API:
mmap-based record IO (``read_records``, ``write_records``), threaded
synthetic generation (``gen_data``, ``gen_queries``, the same bytes as the
JAX module's at the same seed and thread count) and host hardware counters
(``PERF_COUNTER_NAMES``, ``PerfCounters``): the host-side roles the
reference implements in C/C++ (include/io.h, src/write_data.c,
include/perfevent.hpp). Beside them, the partitioned engine's host router
(``routing.cpp``): ``query_ranges``, each predicate's row range, and
``pack_groups``, the greedy packer of the routed queries.

The library is compiled with ``g++`` at first use into
``hvq_tpu_torch/_build/libhvq_native_<hash>.so``, keyed by a hash of the
sources and the flags, as the CUDA kernels are; importing this module
builds nothing. ``available()`` is False only when no C++ compiler is
found; a compile that fails raises with the compiler's message, and every
entry point raises when the library cannot be had. Nothing falls back
quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SOURCE = _DIR / "hvq_native.cpp"
_ROUTING = _DIR / "routing.cpp"
_SELF_TEST = _DIR / "self_test.cpp"
BUILD_DIR = _DIR.parent / "_build"
# The JAX package's Makefile flags, so the generators give the same bytes.
CXXFLAGS = ("-O3", "-march=native", "-std=c++20", "-fPIC", "-Wall", "-Wextra")

_lib = None
_lock = threading.Lock()
# the built library's path, once built or loaded
build_info: dict = {}


def compiler() -> str | None:
    """The C++ compiler: ``$CXX``, else ``g++`` on PATH (None if neither)."""
    cxx = os.environ.get("CXX") or "g++"
    return shutil.which(cxx)


def _key(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.name.encode() if isinstance(p, Path) else str(p).encode())
        if isinstance(p, Path):
            h.update(p.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out: Path, sources, extra=()) -> None:
    """``g++`` the sources into ``out`` (atomically: a temporary, then a
    rename); raises RuntimeError with the compiler's output on failure."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) for hvq_tpu_torch.native")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, *map(str, sources), "-o", str(tmp), *extra, "-pthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def library_path() -> Path:
    """Where the library for these sources and these flags lives."""
    return BUILD_DIR / f"libhvq_native_{_key(_SOURCE, _ROUTING)}.so"


def _load():
    """Build (if needed) and load the library; raises if it cannot."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                so = library_path()
                if not so.exists():
                    _compile(so, [_SOURCE, _ROUTING], extra=("-shared",))
                lib = ctypes.CDLL(str(so))
                _declare(lib)
                build_info.update(path=str(so))
                _lib = lib
    return _lib


def _declare(lib) -> None:
    lib.hvq_read_records.restype = ctypes.c_longlong
    lib.hvq_read_records.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_int,
    ]
    lib.hvq_record_count.restype = ctypes.c_longlong
    lib.hvq_record_count.argtypes = [ctypes.c_char_p]
    lib.hvq_write_records.restype = ctypes.c_int
    lib.hvq_write_records.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_longlong, ctypes.c_longlong,
    ]
    lib.hvq_gen_data.restype = None
    lib.hvq_gen_data.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
    ]
    lib.hvq_gen_queries.restype = None
    lib.hvq_gen_queries.argtypes = list(lib.hvq_gen_data.argtypes)
    lib.hvq_perf_open.restype = ctypes.c_void_p
    lib.hvq_perf_start.argtypes = [ctypes.c_void_p]
    lib.hvq_perf_stop.argtypes = [ctypes.c_void_p]
    lib.hvq_perf_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.hvq_perf_close.argtypes = [ctypes.c_void_p]
    p = np.ctypeslib.ndpointer
    i32, i64, f32, f64 = (p(t, flags="C_CONTIGUOUS") for t in
                          (np.int32, np.int64, np.float32, np.float64))
    ll = ctypes.c_longlong
    lib.hvq_query_ranges.restype = None
    lib.hvq_query_ranges.argtypes = [ll, i32, f64, f64, f64, ll, f32, i64, ll, f32, f32,
                                     i32, i64, i64, i64]
    lib.hvq_pack_groups.restype = ll
    lib.hvq_pack_groups.argtypes = [ll, i64, ll, i64, i64, ll, i64, ll, i32, i64, i64]


def available() -> bool:
    """True once the library is built and loaded; False when there is no
    C++ compiler to build it (a failing compile raises)."""
    if _lib is None and compiler() is None and not library_path().exists():
        return False
    return _load() is not None


def self_test(scratch: str | os.PathLike) -> str:
    """Build ``self_test.cpp`` with the library's source into ``_build/``
    and run it on the scratch file path ``scratch`` (written, read back
    and removed): the threaded generator and reader under concurrency.
    Returns its output; raises if it fails."""
    exe = BUILD_DIR / f"hvq_native_self_test_{_key(_SOURCE, _SELF_TEST)}"
    if not exe.exists():
        _compile(exe, [_SOURCE, _SELF_TEST])
    proc = subprocess.run([str(exe), os.fspath(scratch)], capture_output=True,
                          text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"native self-test failed ({proc.returncode}): "
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_records(path: str | os.PathLike, record_dim: int, threads: int = 0) -> np.ndarray:
    """Read a count-prefixed record file via mmap: (N, record_dim) float32.
    A file shorter than its header says raises ValueError, as the NumPy
    reader of ``utils.formats`` does; an unreadable one OSError."""
    lib = _load()
    p = os.fspath(path).encode()
    size = os.path.getsize(path)           # a missing file: OSError
    n = lib.hvq_record_count(p)
    if n < 0:
        raise ValueError(f"{os.fspath(path)}: missing uint32 count header")
    if size < 4 + 4 * n * record_dim:
        raise ValueError(
            f"{os.fspath(path)}: header says {n} records of {record_dim} floats "
            f"({n * record_dim} values) but file holds {(size - 4) // 4}")
    out = np.empty((n, record_dim), dtype=np.float32)
    got = lib.hvq_read_records(p, record_dim, _fptr(out), n, threads)
    if got != n:
        raise IOError(f"short read from {os.fspath(path)}: {got} != {n}")
    return out


def write_records(path: str | os.PathLike, records: np.ndarray) -> None:
    """Write (N, D) float32 records as a count-prefixed file."""
    lib = _load()
    rec = np.ascontiguousarray(records, dtype=np.float32)
    if lib.hvq_write_records(os.fspath(path).encode(), _fptr(rec), rec.shape[0],
                             rec.shape[1]) != 0:
        raise IOError(f"write failed: {os.fspath(path)}")


def gen_data(n: int, seed: int = 0, categories: int = 0, threads: int = 0) -> np.ndarray:
    """(n, 102) records with write_data.c value semantics, threaded (the
    bytes depend on the thread count: 0 = the host's)."""
    lib = _load()
    out = np.empty((n, 102), dtype=np.float32)
    lib.hvq_gen_data(_fptr(out), n, seed, categories, threads)
    return out


def gen_queries(m: int, seed: int = 1, categories: int = 0, threads: int = 0) -> np.ndarray:
    """(m, 104) queries with write_query.c semantics, threaded."""
    lib = _load()
    out = np.empty((m, 104), dtype=np.float32)
    lib.hvq_gen_queries(_fptr(out), m, seed, categories, threads)
    return out


def _needles(x: np.ndarray) -> np.ndarray:
    """Search needles as float64. NumPy compares float32 keys with needles
    in the two's promoted type, float32 or float64; float64 holds every
    value of either, so the comparisons come out the same."""
    x = np.asarray(x)
    if np.promote_types(x.dtype, np.float32) not in (np.float32, np.float64):
        raise TypeError(f"needles of dtype {x.dtype} do not compare in float32 or float64")
    return np.ascontiguousarray(x, np.float64)


def query_ranges(qtype, v, l, r, cats, bounds, T_key, T_sorted):
    """Each query's (view, start, end) of the partitioned index
    (``index.partition.PartitionedIndex.query_ranges``), and the counts
    (table, segment, time) of the queries resolved by the category table
    (types 1 and 3), by the type-3 segment search and by the type-2 search.
    ``cats``, ``bounds``: the cat view's distinct C keys and their first
    rows, then n; ``T_key``: its T keys; ``T_sorted``: every T, sorted."""
    lib = _load()
    qtype = np.ascontiguousarray(qtype, np.int32)
    v, l, r = map(_needles, (v, l, r))
    cats = np.ascontiguousarray(cats, np.float32)
    bounds = np.ascontiguousarray(bounds, np.int64)
    T_key = np.ascontiguousarray(T_key, np.float32)
    T_sorted = np.ascontiguousarray(T_sorted, np.float32)
    m, n = qtype.shape[0], T_key.shape[0]
    if not (v.shape == l.shape == r.shape == (m,) and bounds.shape == (cats.size + 1,)
            and T_sorted.shape == (n,) and bounds[-1] == n):
        raise ValueError("query_ranges: mismatched shapes")
    view = np.empty(m, np.int32)
    start = np.empty(m, np.int64)
    end = np.empty(m, np.int64)
    counts = np.empty(3, np.int64)
    lib.hvq_query_ranges(m, qtype, v, l, r, cats.size, cats, bounds, n, T_key, T_sorted,
                         view, start, end, counts)
    return view, start, end, tuple(int(c) for c in counts)


def pack_groups(start, end, q_idx, caps, group):
    """The greedy packer of the routed queries ``q_idx`` into shared
    windows (``models.partitioned.PartitionedEngine._pack_groups``): each
    group as the walk closes it, (cap index into ``caps`` int32 (NG,),
    window start int64 (NG,), members int64 (NG, ``group``), -1 past the
    last)."""
    lib = _load()
    start = np.ascontiguousarray(start, np.int64)
    end = np.ascontiguousarray(end, np.int64)
    q_idx = np.ascontiguousarray(q_idx, np.int64)
    caps = np.ascontiguousarray(caps, np.int64)
    nq, m = q_idx.shape[0], start.shape[0]
    if end.shape != (m,):
        raise ValueError("pack_groups: start and end differ in shape")
    if nq and not caps.size:
        raise ValueError("pack_groups: no caps to pack into")
    g_cap = np.empty(nq, np.int32)
    g_start = np.empty(nq, np.int64)
    members = np.empty((nq, group), np.int64)
    ng = lib.hvq_pack_groups(nq, q_idx, m, start, end, caps.size, caps, group, g_cap,
                             g_start, members)
    if ng < 0:
        raise IndexError(f"pack_groups: a query index outside [0, {m})")
    return g_cap[:ng], g_start[:ng], members[:ng]


PERF_COUNTER_NAMES = (
    "cycles", "kcycles", "instructions", "L1d_misses",
    "LLC_misses", "branch_misses", "task_clock_ns",
)


class PerfCounters:
    """Host hardware counters around a block (perfevent.hpp analogue).

    >>> with PerfCounters() as pc:
    ...     work()
    >>> pc.report()   # {'cycles': ..., 'IPC': ...}

    ``perf_event_open`` may refuse any counter (a container's
    perf_event_paranoid or seccomp rules): a refused counter reads back
    negative and is left out of ``values``, so only the counters the host
    allowed are reported (often just ``task_clock_ns``).
    """

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.hvq_perf_open()
        self.values: dict[str, float] = {}

    def __enter__(self):
        if self._h:
            self._lib.hvq_perf_start(self._h)
        return self

    def __exit__(self, *exc):
        if self._h:
            self._lib.hvq_perf_stop(self._h)
            buf = (ctypes.c_double * len(PERF_COUNTER_NAMES))()
            self._lib.hvq_perf_read(self._h, buf)
            vals = dict(zip(PERF_COUNTER_NAMES, buf))
            self.values = {k: v for k, v in vals.items() if v >= 0}
        return False

    def close(self):
        if self._h:
            self._lib.hvq_perf_close(self._h)
            self._h = None

    def report(self) -> dict:
        """The allowed counters, plus IPC and GHz where cycles,
        instructions and the task clock all ran."""
        out = dict(self.values)
        cyc = out.get("cycles", -1)
        ins = out.get("instructions", -1)
        if cyc > 0 and ins > 0:
            out["IPC"] = ins / cyc
        tc = out.get("task_clock_ns", -1)
        if tc > 0 and cyc > 0:
            out["GHz"] = cyc / tc
        return out
