"""The card's counterpart of ``experiments/pallas_probe.py``: a hand kernel
builds and runs (``_trivial``, o = 2·x), then K3 is timed against the plain
lane scan and their agreement reported as the script reports it.

    python -m hvq_tpu_torch.tools.pallas_probe [--out chiprun_out/pallas_probe.json]
                                               [--reference DIR]

``_trivial`` runs on a (256, 128) fp32 array, held bit for bit against
``x * 2`` (its plain version, which is also the one PyTorch call that
computes it), both timed, beside its bound (one read and one write of the
array at the HBM rate). At that size the host's launch path is the time,
so each is timed three ways, the two taking turns: CUDA events around
10³ calls (``ms``); the host clock over 10⁴ calls in a row started after a
``synchronize()`` (``host_us``, µs a call), with the events read around
the same calls (``same_loop_us``); and the kernel's own duration in a
``torch.profiler`` trace (``device_ms``). The launch path's steps are
timed on the host clock alone (``launch_path``: ``kernels.run`` with a
no-op call, the output's allocation, the C entry through ctypes, and the
three input ops every scan launch derives at B = 1024).
``--reference DIR`` (another tree's root, e.g. an earlier commit unpacked
with ``git archive``) times the launch path of DIR's package and of this
one's in turns (this, DIR, this, DIR), each in a fresh interpreter. Then,
at the script's shape (B 256, Dt 8192, 128
tiles, R = ``kernel_bin_top``; rows, predicates and queries as the script
draws them, made on the card from a seed), K3 (``kernels.packed_scan``)
against ``packed_scan_plain(layout="lane", precision="highest")``, the port
of ``deferred_packed_scan_xla``: the time of each and the share of entries
whose distances agree (``isclose``, or both +inf) and, of those, whose
positions agree. Prints one line per step and one JSON object, also
written to ``--out``. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from hvq_tpu_torch.models.batched import _CERT_REL_MM
from hvq_tpu_torch.ops import kernels, probe_kernels
from hvq_tpu_torch.ops.distance import require_ieee_fp32
from hvq_tpu_torch.ops.masks import query_predicate_fields
from hvq_tpu_torch.ops.scan import kernel_bin_top, packed_scan_plain
from hvq_tpu_torch.tools.card import (PEAK_FP32, bound, card_line, event_ms,
                                      require_card)
from hvq_tpu_torch.utils.check import scan_agreement

B, DT, NT = 256, 8192, 128            # experiments/pallas_probe.py:19-21
TRIVIAL_SHAPE = (256, 128)            # :30
REPLACES = "experiments/pallas_probe.py:32"
SOURCE = "hvq_tpu_torch/csrc/probes.cu"


def trivial_bound(n: int = TRIVIAL_SHAPE[0] * TRIVIAL_SHAPE[1]) -> dict:
    """n fp32 multiplies on the CUDA cores; n·4 bytes read, n·4 written."""
    return bound(n, PEAK_FP32, 2 * n * 4)


def trivial_check(seed: int = 0) -> dict:
    """``_trivial`` on the card: bit for bit against its plain version."""
    dev = require_card()
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(TRIVIAL_SHAPE, device=dev, generator=g)
    t0 = time.perf_counter()
    got = probe_kernels.trivial(x)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    same = bool(torch.equal(got.view(torch.int32), (x * 2).view(torch.int32)))
    print(f"trivial kernel OK in {first:.1f}s (build and first launch); "
          f"bit-identical to x*2: {same}", flush=True)
    if not same:
        raise AssertionError("trivial differs from x * 2")
    return dict(first_call_s=first, max_abs_err=0.0)


HOST_CALLS = 10_000


def clocks(fn, calls: int = HOST_CALLS) -> dict:
    """CUDA events and the host clock around the same ``calls`` calls of
    ``fn`` in a row (one warm-up, a ``synchronize()`` before): µs a call by
    each. The host clock is what the host spends to enqueue them (the
    queue is drained after it stops); the events span what the card did
    between the first call's enqueue and the last's end, so they exceed
    the host clock only by what the card runs behind."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    b.record()
    torch.cuda.synchronize()
    return dict(events=a.elapsed_time(b) / calls * 1e3, host=(t1 - t0) / calls * 1e6)


def device_ms(fn, match: str, calls: int = 200) -> dict:
    """The device time a call of the kernels whose names contain ``match``,
    from a ``torch.profiler`` trace of ``calls`` calls of ``fn`` (their self
    device time summed over the trace, over ``calls``), with the kernels'
    names; ``device_ms`` is None when the trace holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if match in e.key]
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
             for e in rows)
    return dict(device_ms=us / calls / 1e3 if rows and us else None,
                kernels=sorted(e.key for e in rows))


def launch_path(calls: int = HOST_CALLS) -> dict:
    """Host µs a call of ``probe_kernels.trivial`` and ``x * 2`` at the
    script's shape, and of the trivial path's steps: ``kernels.run`` with a
    no-op call (device check and stream handle), ``torch.empty_like`` (the
    output), the C entry called through ctypes with its arguments ready
    (the launch and its error check); then the three input ops every scan
    launch derives (``kernels._launch``: ‖q‖², and the predicate flags as
    int32) at B = 1024. Uses only what every tree of the port has, so
    ``--reference`` can time an older one."""
    dev = require_card()
    x = torch.randn(TRIVIAL_SHAPE, device=dev)
    out = torch.empty_like(x)
    entry = probe_kernels.build().hvq_probe_trivial
    ready = (x.data_ptr(), out.data_ptr(), x.numel(), torch.cuda.current_stream().cuda_stream)
    qV = torch.randn(1024, 128, device=dev)
    ac, at = torch.rand(1024, device=dev) < 0.5, torch.rand(1024, device=dev) < 0.5

    def inputs():
        (qV * qV).sum(dim=1)
        ac.to(torch.int32)
        at.to(torch.int32)

    def host_us(fn):
        return clocks(fn, calls)["host"]

    return dict(trivial=host_us(lambda: probe_kernels.trivial(x)),
                x2=host_us(lambda: x * 2),
                run_noop=host_us(lambda: kernels.run("noop", x.device, lambda s: 0)),
                empty_like=host_us(lambda: torch.empty_like(x)),
                entry=host_us(lambda: entry(*ready)),
                launch_inputs=host_us(inputs))


def in_turns(fns: dict, timer, rounds: int = 3) -> dict:
    """``timer(fn)`` of each of ``fns`` (name → fn) in ``rounds`` rounds, the
    functions taking turns inside each; the median of each name's rounds."""
    got = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            got[name].append(timer(fn))
    return {name: statistics.median(v) for name, v in got.items()}


def trivial_time(seed: int = 0, reps: int = 1000) -> dict:
    """``_trivial`` and ``x * 2`` (and the plain version, which is ``x * 2``
    too) timed by CUDA events around ``reps`` calls (ms a call), the median
    of three rounds taken in turns; by both clocks around the same 10⁴
    calls in three rounds taken in turns, each round kept (``same_loop_us``:
    where they part, the card runs behind the host) and the host clock's
    median reported (``host_us``, ``library_host_us``, µs a call); the
    launch path's steps (``launch_path_us``); and the profiler's kernel
    durations (``device_ms``, ``library_device_ms``); beside the bound."""
    dev = require_card()
    x = torch.randn(TRIVIAL_SHAPE, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
    fns = {"ms": lambda: probe_kernels.trivial(x),
           "plain_ms": lambda: probe_kernels.trivial_plain(x),
           "library_ms": lambda: x * 2}
    ms = in_turns(fns, lambda fn: event_ms(fn, reps))
    same_loop = {"trivial": [], "x2": []}
    for _ in range(3):
        for name, fn in zip(same_loop, (fns["ms"], fns["library_ms"])):
            same_loop[name].append(clocks(fn))
    host = {key: statistics.median(r["host"] for r in same_loop[name])
            for key, name in (("host_us", "trivial"), ("library_host_us", "x2"))}
    path = launch_path()
    dev_k = device_ms(fns["ms"], "trivial_kernel")
    dev_x = device_ms(fns["library_ms"], "elementwise_kernel")
    res = dict(**ms, **trivial_bound(), **host, same_loop_us=same_loop, launch_path_us=path,
               device_ms=dev_k["device_ms"], library_device_ms=dev_x["device_ms"],
               profiled_kernels=dev_k["kernels"] + dev_x["kernels"])
    print(f"trivial {res['ms']:.5f} ms, plain {res['plain_ms']:.5f} ms, x*2 "
          f"{res['library_ms']:.5f} ms, bound {res['bound_ms']:.7f} ms ({res['bound_by']}); "
          f"host µs a call: trivial {res['host_us']:.3f}, x*2 {res['library_host_us']:.3f}; "
          f"events and host µs a call of the same calls: {json.dumps(same_loop)}; "
          f"launch path {json.dumps(path)}; device ms a launch: trivial {res['device_ms']}, "
          f"x*2 {res['library_device_ms']} ({res['profiled_kernels']})", flush=True)
    return res


def launch_path_in_turns(reference: str, rounds: int = 2) -> dict:
    """:func:`launch_path` of this tree's package and of ``reference``'s (a
    tree root holding ``hvq_tpu_torch/``), in turns, each in a fresh
    interpreter with that tree first on the path."""
    here = str(Path(__file__).resolve().parents[2])
    out = {"here": [], "reference": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(2 * rounds):
            side, root = (("here", here), ("reference", reference))[i % 2]
            path = os.path.join(tmp, f"{i}.json")
            env = {**os.environ, "PYTHONPATH": os.path.abspath(root)}
            subprocess.run([sys.executable, os.path.abspath(__file__), "--launch-path-only",
                            "--out", path], env=env, check=True)
            with open(path) as f:
                out[side].append(json.load(f))
            print(f"launch path [{side}]: {json.dumps(out[side][-1])}", flush=True)
    return out


def k3_inputs(seed: int = 0, b: int = B, dt: int = DT, nt: int = NT):
    """The script's data (pallas_probe.py:47-59) made on the card: standard
    normal rows and queries in all 128 lanes, C in 0..999, T in U(−3, 3),
    half the queries with each predicate."""
    dev = require_card()
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pad = nt * dt
    Vp = torch.randn((n_pad, 128), device=dev, generator=g)
    C = torch.randint(0, 1000, (n_pad,), device=dev, generator=g).float()
    T = torch.rand(n_pad, device=dev, generator=g) * 6 - 3
    dn = (Vp * Vp).sum(1)
    oid = torch.arange(n_pad, dtype=torch.int32, device=dev)
    qV = torch.randn((b, 128), device=dev, generator=g)
    ac = torch.rand(b, device=dev, generator=g) < 0.5
    at = torch.rand(b, device=dev, generator=g) < 0.5
    qtype = ac.int() + 2 * at.int()
    v = torch.randint(0, 1000, (b,), device=dev, generator=g).float()
    l = torch.rand(b, device=dev, generator=g) * -3
    r = torch.rand(b, device=dev, generator=g) * 3
    return (Vp, C, T, dn, oid, qV, *query_predicate_fields(qtype, v, l, r), n_pad)


def k3_check(seed: int = 0, reps: int = 5) -> dict:
    """K3 and the plain lane scan at the script's shape: agreement, then
    both timed (pallas_probe.py:61-92)."""
    require_ieee_fp32(require_card())
    args = k3_inputs(seed)
    n_pad = args[-1]
    R = kernel_bin_top(DT, n_pad)
    print(f"B={B} DT={DT} NT={NT} rows={n_pad} bin_top={R}", flush=True)
    kw = dict(db_tile=DT, bin_top=R)
    s_k, i_k = kernels.packed_scan(*args, **kw)
    s_p, i_p = packed_scan_plain(*args, **kw, layout="lane", precision="highest")
    same = torch.isclose(s_k, s_p)
    fin = torch.isfinite(s_k)
    ok = same & fin
    dist_agree = float((same | ~fin).float().mean())
    id_agree = float((i_k[ok] == i_p[ok]).float().mean()) if ok.any() else 1.0
    print(f"dist agree: {dist_agree}  id agree(on same): {id_agree}", flush=True)
    # isclose's 1e-5 is below one key quantum (2⁻¹⁶): the port's contract
    # is one quantum plus the fp32-plane certificate slack
    qV, dn = args[5], args[3]
    a = scan_agreement(s_k, i_k, s_p, i_p, R, DT // 128, (qV * qV).sum(1),
                       float(dn.max()), _CERT_REL_MM)
    print(f"K3 vs plain (scan_agreement): {a}", flush=True)
    if not a["ok"]:
        raise AssertionError(f"K3 disagrees with the plain lane scan: {a}")
    del s_k, i_k, s_p, i_p, same, fin, ok
    res = dict(B=B, db_tile=DT, tiles=NT, bin_top=R, dist_agree=dist_agree,
               id_agree=id_agree, max_abs_err=a["max_abs_err"])
    for name, fn in (
        ("xla_packed (plain)", lambda: packed_scan_plain(*args, **kw, layout="lane",
                                                         precision="highest")),
        ("pallas_packed (K3)", lambda: kernels.packed_scan(*args, **kw)),
    ):
        ms = event_ms(fn, reps)
        print(f"{name:24s} {ms:8.2f} ms  -> {B / ms * 1e3:9.0f} QPS(scan-only)", flush=True)
        res["plain_ms" if "plain" in name else "k3_ms"] = ms
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/pallas_probe.json")
    ap.add_argument("--reference", help="another tree's root: time its launch path "
                                        "and this one's in turns")
    ap.add_argument("--launch-path-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    dev = require_card()
    if args.launch_path_only:
        with open(args.out, "w") as f:
            json.dump(launch_path(), f)
        return 0
    print(f"device: {torch.cuda.get_device_name(dev)} ({card_line()})", flush=True)
    res = dict(trivial=dict(**trivial_check(), **trivial_time()), k3=k3_check())
    if args.reference:
        res["launch_path_in_turns"] = launch_path_in_turns(args.reference)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
