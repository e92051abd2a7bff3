#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero with a traceback:

1. probe: a CUDA device must be present (there is no CPU path); prints
   the card's name and power limit, torch, CUDA and nvcc versions;
2. build: compiles the CUDA kernel K1 from ``hvq_tpu_torch/csrc``;
3. kernel vs plain: K1 against its plain PyTorch version on the card,
   over both scan planes, several bin depths R and tile sizes, a window,
   mixed predicates and a sample limit;
4. main path at D=10⁶ rows, fp32 scan plane: the batched engine on 10⁴
   mixed queries, checked against the NumPy oracle (64 queries: recall@100
   = 1.0, recomputed .dist within 0.002) and, for every query, against the
   streaming exact path; K1 timed beside its plain version at the
   main-path shape;
5. main path at D=10⁷ rows, bf16 scan plane: the same.

The last three lines are the card (``nvidia-smi`` name, power limit), a
JSON object describing each kernel of the path, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from hvq_tpu.models.oracle import search_oracle_batched  # noqa: E402
from hvq_tpu.utils.compare import compare_distances, recall_at_k  # noqa: E402
from hvq_tpu.utils.formats import QuerySet, recompute_result_distances  # noqa: E402
from hvq_tpu.utils.generators import generate_dataset, generate_queries  # noqa: E402
from hvq_tpu_torch import get_engine  # noqa: E402
from hvq_tpu_torch.models import batched  # noqa: E402
from hvq_tpu_torch.ops import kernels  # noqa: E402
from hvq_tpu_torch.ops.distance import require_ieee_fp32  # noqa: E402
from hvq_tpu_torch.ops.masks import query_predicate_fields  # noqa: E402
from hvq_tpu_torch.ops.scan import packed_scan_plain  # noqa: E402
from hvq_tpu_torch.utils.check import scan_agreement  # noqa: E402
from hvq_tpu_torch.utils.timing import PhaseTimer  # noqa: E402

DEV = torch.device("cuda")
K1 = dict(
    name="packed_scan_v3", route="cuda",
    source="hvq_tpu_torch/csrc/packed_scan_v3.cu",
    replaces="hvq_tpu/ops/pallas_scan.py:1021",
)
M_QUERIES = 10_000
CATEGORIES = 1000


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def probe() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke runs only on a GPU")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    log("nvcc: " + nvcc.strip().splitlines()[-1])
    require_ieee_fp32(DEV)
    return card


def build() -> None:
    t0 = time.perf_counter()
    kernels.build()
    info = kernels.build_info
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s, "
        f"compiled={info['compiled']}) -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())


def scan_inputs(Vs, C, T, dn, qV, qtype, v, l, r):
    """Device tensors of one scan call from host arrays."""
    t = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x)).to(DEV, dt)
    fields = query_predicate_fields(t(qtype, torch.int32), t(v), t(l), t(r))
    oid = torch.arange(Vs.shape[0], dtype=torch.int32, device=DEV)
    return (Vs, C, T, dn, oid, t(qV), *fields)


def compare_once(args, sn, db_tile, R, row0=None, ntw=None):
    """K1 and its plain version on the same inputs; returns the agreement.

    Both planes are held to the fp32-plane slack: on the bf16 plane both
    sides form the same exact bf16·bf16 products and differ only in fp32
    summation order."""
    kw = dict(db_tile=db_tile, bin_top=R, row0=row0, ntw=ntw)
    d_k, p_k = kernels.packed_scan_v3(*args, sn, **kw)
    d_p, p_p = packed_scan_plain(*args, sn, **kw)
    torch.cuda.synchronize()
    qV, dn = args[5], args[3]
    return scan_agreement(d_k, p_k, d_p, p_p, R, db_tile // 128,
                          (qV * qV).sum(1), float(dn.max()),
                          batched._CERT_REL_MM)


def kernel_vs_plain() -> float:
    """Phase 3: small cases over planes, R, tiles, windows, predicates."""
    rng = np.random.default_rng(5)
    n_pad, B = 65536, 100
    V = rng.uniform(-6, 6, (n_pad, 128)).astype(np.float32)
    V[:, 100:] = 0.0
    qV = rng.uniform(-6, 6, (B, 128)).astype(np.float32)
    qV[:, 100:] = 0.0
    V[17] = qV[3]                                 # exact duplicate → dist 0
    Vf = torch.from_numpy(V).to(DEV)
    C = torch.from_numpy(rng.integers(0, 4, n_pad).astype(np.float32)).to(DEV)
    T = torch.from_numpy(rng.uniform(-3, 3, n_pad).astype(np.float32)).to(DEV)
    dn = (Vf * Vf).sum(1)
    qtype = rng.integers(0, 4, B)
    v = rng.integers(0, 4, B).astype(np.float32)
    l = rng.uniform(-3, 0, B).astype(np.float32)
    r = rng.uniform(0, 3, B).astype(np.float32)
    worst = 0.0
    for plane in ("fp32", "bf16"):
        Vs = Vf if plane == "fp32" else Vf.to(torch.bfloat16)
        args = scan_inputs(Vs, C, T, dn, qV, qtype, v, l, r)
        cases = [(16384, R, None, None, n_pad) for R in (1, 2, 3, 4, 6, 24)]
        cases += [(1024, R, None, None, 60000) for R in (2, 3, 24, 128)]
        cases += [(1024, 3, 5 * 1024, 7, 60000), (16384, 2, 16384, 2, 50000)]
        for db_tile, R, row0, ntw, sn in cases:
            a = compare_once(args, sn, db_tile, R, row0, ntw)
            log(f"  kernel vs plain [{plane} Dt={db_tile} R={R} row0={row0} "
                f"ntw={ntw} sn={sn}]: ok={a['ok']} max_abs_err={a['max_abs_err']:.3g} "
                f"tol_ratio={a['tol_ratio']:.3g} same_pos={a['same_pos']:.6f}")
            if not a["ok"]:
                raise AssertionError(f"K1 disagrees with its plain version: {a}")
            worst = max(worst, a["max_abs_err"])
    # query 3's exact duplicate (row 17) comes first, at a distance within
    # the matmul slack of 0, and no distance is −0.0 (a negative key)
    args = scan_inputs(Vf, C, T, dn, qV, np.zeros(B), v, l, r)
    d_k, p_k = kernels.packed_scan_v3(*args, n_pad, db_tile=1024, bin_top=1)
    i = int(torch.argmin(d_k[3]))
    slack = batched._CERT_REL_MM * 2 * float((args[5][3] ** 2).sum())
    assert int(p_k[3, i]) == 17 and 0.0 <= float(d_k[3, i]) <= slack
    assert not torch.signbit(d_k).any()
    return worst


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main_path(n: int, scan_store: str, seed: int) -> dict:
    tag = f"D={n:.0e} {scan_store}"
    t0 = time.perf_counter()
    ds = generate_dataset(n, seed=seed, categories=CATEGORIES)
    qs = generate_queries(M_QUERIES, seed=seed + 1, categories=CATEGORIES)
    log(f"[{tag}] data {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eng = get_engine("batched")(ds, device=DEV, scan_store=scan_store)
    torch.cuda.synchronize()
    log(f"[{tag}] engine build {time.perf_counter() - t0:.1f} s: n_pad={eng.db.n_pad} "
        f"db_tile={eng.db.db_tile} R={eng.bin_top} k'={eng.kprime} "
        f"B={eng.query_batch} scan_impl={eng.scan_impl} certified={eng.certified}")
    assert eng.scan_impl == "v3" and eng.certified

    # K1 vs plain at the main-path shape (first query batch)
    db, B = eng.db, eng.query_batch
    Qp = batched.pack_query_block(qs.V[:B], qs.qtype[:B], qs.v[:B], qs.l[:B],
                                  qs.r[:B])
    qV = torch.zeros((B, 128), device=DEV)
    qV[:, :100] = torch.from_numpy(Qp[:, :100]).to(DEV)
    fields = query_predicate_fields(*(torch.from_numpy(Qp[:, 100 + j].copy()).to(DEV)
                                      for j in range(4)))
    args = (db.scan_V, db.C, db.T, db.d_norms, eng._pos, qV, *fields, n)
    kw = dict(db_tile=db.db_tile, bin_top=eng.bin_top)
    d_k, p_k = kernels.packed_scan_v3(*args, **kw)
    d_p, p_p = packed_scan_plain(*args, **kw)
    agree = scan_agreement(d_k, p_k, d_p, p_p, eng.bin_top, db.db_tile // 128,
                           (qV * qV).sum(1), eng._dn_max, eng._rel_mm)
    del d_k, p_k, d_p, p_p
    log(f"[{tag}] K1 vs plain at B={B}: {agree}")
    assert agree["ok"], agree
    reps = 10 if n <= 2_000_000 else 3
    ms = time_ms(lambda: kernels.packed_scan_v3(*args, **kw), reps)
    plain_ms = time_ms(lambda: packed_scan_plain(*args, **kw), reps)
    log(f"[{tag}] K1 {ms:.3f} ms/call, plain {plain_ms:.3f} ms/call "
        f"(B={B}, Dt={db.db_tile}, R={eng.bin_top}, n_pad={db.n_pad})")

    # warm-up, then the timed main path with the launch count around it
    eng.search(generate_queries(B, seed=seed + 2, categories=CATEGORIES))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    ids, dists = eng.search(qs)
    wall = time.perf_counter() - t0
    launches = kernels.launches["packed_scan_v3"]
    ladder = dict(eng.last_ladder)
    n_batches = -(-qs.m // B)
    log(f"[{tag}] search {qs.m} queries: {wall:.3f} s = {qs.m / wall:.1f} QPS; "
        f"K1 launches {launches}; ladder {ladder}")
    assert launches == n_batches + ladder.get("rung1_runs", 0), launches
    if ladder["suspects"]:
        assert ladder["rung1_runs"] >= 1
        assert ladder["rung1_bin_top"] == 2 * eng.bin_top, ladder
    assert ids.shape == (qs.m, 100) and dists.shape == (qs.m, 100)
    assert np.isfinite(dists).all() and (ids < n).all()

    phases = PhaseTimer(device=DEV)
    eng.search(qs, phases=phases)
    log(f"[{tag}] phases (fenced run): {json.dumps(phases.as_dict())}")

    # 64-query oracle check
    t0 = time.perf_counter()
    sub = QuerySet(qtype=qs.qtype[:64], v=qs.v[:64], l=qs.l[:64], r=qs.r[:64],
                   V=qs.V[:64])
    oids, odists = search_oracle_batched(ds, sub)
    rec = recall_at_k(ids[:64], oids, dists[:64], odists)
    res = compare_distances(
        recompute_result_distances(ds, sub, ids[:64].astype(np.int64)),
        recompute_result_distances(ds, sub, oids.astype(np.int64)),
    )
    log(f"[{tag}] oracle (64 queries, {time.perf_counter() - t0:.1f} s): "
        f"recall@100={rec} dist={res.status} max|Δ|={res.max_abs_diff}")
    assert rec == 1.0 and res.ok, (rec, res)

    # every query against the streaming exact path (a different code path)
    t0 = time.perf_counter()
    stream = get_engine("batched")(ds, device=DEV, device_db=db, scan_impl="stream")
    s_ids, _ = stream.search(qs)
    full = compare_distances(
        recompute_result_distances(ds, qs, ids.astype(np.int64)),
        recompute_result_distances(ds, qs, s_ids.astype(np.int64)),
    )
    log(f"[{tag}] stream path, all {qs.m} queries ({time.perf_counter() - t0:.1f} s): "
        f"{full.status} max|Δ|={full.max_abs_diff} beyond={full.num_exceeding}")
    assert full.ok, full
    return dict(qps=qs.m / wall, ms=ms, plain_ms=plain_ms, launches=launches,
                max_abs_err=agree["max_abs_err"], suspects=ladder["suspects"])


def main() -> int:
    card = probe()
    build()
    worst = kernel_vs_plain()
    log(f"kernel vs plain: all cases ok, max_abs_err {worst:.3g}")
    r6 = main_path(1_000_000, "fp32", seed=100)
    torch.cuda.empty_cache()
    r7 = main_path(10_000_000, "bf16", seed=200)
    # the library's file name carries the hash of the kernel sources and
    # nvcc flags it was built from
    k1 = dict(K1, library=os.path.basename(kernels.build_info["path"]),
              launches=r6["launches"] + r7["launches"],
              max_abs_err=max(worst, r6["max_abs_err"], r7["max_abs_err"]),
              ms=r6["ms"], plain_ms=r6["plain_ms"],
              ms_d1e7_bf16=r7["ms"], plain_ms_d1e7_bf16=r7["plain_ms"],
              qps_d1e6=r6["qps"], qps_d1e7=r7["qps"])
    log(card)
    log(json.dumps({"kernels": [k1]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
