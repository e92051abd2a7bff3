#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero with a traceback:

1. probe: a CUDA device must be present (there is no CPU path); prints
   the card's name and power limit, torch, CUDA and nvcc versions;
2. build: compiles the CUDA kernels K1–K4 from ``hvq_tpu_torch/csrc``
   into one library and, at the same time, the TPU probe kernels into a
   second one (``ops/probe_kernels.py``), and prints ptxas' registers and
   spills per kernel and instantiation;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card — K1 over both scan planes, bin depths R (its tensor-core body for
   R ≤ 8, its CUDA-core body above), tiles, windows, mixed predicates and
   a sample limit; K3 and K2 over R (the tensor-core body for R ≤ 8, the
   CUDA-core body above) and tiles with a sample limit, a permuted ``oid``,
   B = 1000 queries (a ragged last query block) at 8-bin tiles, and
   data in lanes 112–127 (the product's 8th k-step); K4 the same way
   (its tensor-core body for R ≤ 8, R = 16 on its CUDA-core body) and
   over tiles, a permuted ``oid``, a predicate that empties whole bins
   (padding ids), negative scores and rows that tie bit for bit (the
   lowest lanes kept); every lane kernel's launches counted per body;
3b. certificate error: the kept distances of K1 (both planes), of K3
   and K2 (their main-path shape, Dt = 8192, R = 4) and of K4 (score +
   ‖q‖², Dt = 2048, R = 2), at unit and adversarial norms (the
   scale-4096 layout of the certificate stress test), against their true
   values in fp64, as a share of the certificate's slack
   ``rel_mm·(‖q‖² + max‖d‖²)`` (must stay ≤ 0.5); K1's also on the 240 a
   query that the level-2 select keeps of its stream;
3c. determinism: K1, K3, K2 and K4 five times on the same inputs: K1 over
   both planes, R of both bodies, 8 main-path tiles and 8-bin tiles, with
   CTAs enough for two an SM; K3, K2 and K4 at B = 1024 over 8 tiles of
   8192 rows at R 1–4 and 8, 8-bin tiles at R 3 and one R = 32 case on
   the CUDA-core body; the level-2 select at B = 1024, W = 117,120 over
   both bodies and both layouts; the outputs must be bit-identical (every
   kernel is also rerun and held bit for bit at its main-path shape in
   phases 4–7);
3d. the TPU probe kernels (the three Pallas kernels of ``experiments/``,
   each driven by its tool, ``hvq_tpu_torch/tools/``): every variant
   against its plain version on small cases (the K1 anatomy's six stages
   on the fp32, bf16 and int8 planes at R 1–4, B = 100 and 1000 (a ragged
   query block), three tiles, mixed predicates, a sample limit and a bin
   whose rows are all masked, mmc at R 1 and two 16384-row tiles; the
   int8 probe's four variants at B 100, 256 and 1000 over 2–3 tiles;
   ``_trivial`` on an odd size), then each at its script's own shape and
   rerun twice bit for bit; ``pallas_probe``'s K3 check (K3 against the
   plain lane scan at B 256, Dt 8192, 128 tiles); then, with the probe
   counts at 0, the tools' timing runs (the 15 anatomy variants and four
   cuts of K1 on the bf16 plane, the four
   int8-probe variants with the int8 transpose alone and the product-only
   yardsticks ``torch.matmul`` / ``torch._int_mm``, ``_trivial`` beside
   ``x * 2`` by CUDA events, by the host clock over 10⁴ calls with each
   step of the launch path, and by the profiler's kernel durations), each
   beside its bound and its plain version's time. int8 variants must
   equal their plain versions bit for bit;
4. main paths at D=10⁶ rows: one dataset, its 64-query oracle answer and
   the streaming exact path's answer for all 10⁴ mixed queries, computed
   once; then the batched engine with K1 (``scan_impl="v3"``, fp32 plane),
   K3 (``"v1"``) and K2 (``"v2"``), each held to both answers, with its
   launch counts, ladder, fenced phases and its kernel timed beside its
   plain version at the main-path shape;
5. K4 at B=1024 over the same rows (Dt=2048, R=2, its own defaults): K4
   has no engine, so this call is its path: one launch, on the
   tensor-core body, held to its plain version and rerun twice bit for
   bit; timed beside its plain version, its bound and the six passes'
   product alone;
6. main path at D=10⁷ rows, bf16 scan plane, through K1: the same checks;
7. the partitioned engine over phase 6's rows (bf16 plane) and 4·10⁴
   mixed queries (phase 6's 10⁴, then 3·10⁴ more): K1 held to its plain
   version on one windowed batch of the time view; a warm-up search that
   pays the time view's build; the timed search with its launch counts
   (K1 = full + windowed batches + rung-1 runs, nothing else) and route
   counts; a fenced phase run; recall and ``.dist`` on the 64 oracle
   queries, and every query within 0.002 of the batched K1 engine;
8. the paged engine over phase 6's host rows and queries on the fp32
   plane (k′ 128), windows of 2,500,000 rows rounded to 2,490,368 (five,
   the last 38,528): K1 at the window's shape held to its plain version
   and timed; after a warm-up, the timed search with its launch counts
   (K1 = windows × batches, nothing else, all on the tensor-core body)
   and each window uploaded exactly once; a fenced phase run with the
   upload rate; recall and ``.dist`` on the 64 oracle queries and every
   query within 0.002 of phase 6's batched K1 answer (bf16 plane); the
   default window the card's free memory gives;
9. the IVF engine at ``experiments/ivf_scale.py``'s settings (10⁷ rows
   in 1000 clusters, 4096 type-0 queries from the same centres, cap 1024,
   query_batch 1024): the index built on the card (k-means included),
   QPS after a warm-up, recall@100 ≥ 0.99 on 64 oracle queries, and no
   scan kernel launched;
9a. the ``sharded`` engine over phase 6's 10⁷ host rows and 10⁴ queries
   on the fp32 plane, B 1024, on a mesh of 4 virtual shards of the card
   (n_pad 10,027,008, 153 tiles a shard): one database copy of card
   memory; K1 at the shard's shape (a slab view at an offset) held to its
   plain version and, bit for bit, to K1 on a copy of the slab, then
   timed; after a warm-up the timed search (K1 = 4 × (batches + rung-1
   runs), all on the tensor-core body), a fenced phase run (per-shard
   scan, select, refine, merge, finalize, certificate, fetch, rerun),
   recall and ``.dist`` on the 64 oracle queries and every query within
   0.002 of phase 6's batched answer; then the same on a 1-shard mesh;
9b. ``sharded`` with ``scan_impl="pallas"`` (K3 per shard, Dt 8192) on
   phase 4's 10⁶ rows and queries, on a 2×2 (q, d) mesh of the card: the
   same checks, K3 at the shard's shape, held to phase 4's streaming
   answer;
9c. ``partitioned_sharded`` over phase 6's rows on the bf16 plane with
   phase 7's 4·10⁴ queries, 4 virtual shards: a warm-up (the time view,
   dealt tile by tile), the timed search (K1 = 4 × (full + windowed
   batches + rung-1 runs), routed groups homed to their shards, straddling
   spans and narrow type-2 spans dense),
   a fenced phase run, recall and ``.dist`` on the oracle queries, and
   every query within 0.002 of phase 7's partitioned answer; each mesh
   phase prints its peak of card memory and frees its engine;
10a. ``repair_bins=2`` (the in-program bin repair) and the certificate's
   forensics (``HVQ_CERT_TERMS=1``) on the card: the batched K1 engine on
   phase 6's database (bf16 plane), the partitioned engine on phase 7's
   index and queries, then again with ``repair_gate=True``, the paged
   engine at phase 8's windows, ``sharded`` on 4 virtual shards (9a) and
   ``partitioned_sharded`` (9c): each after a warm-up, its timed search
   with the launch counts (K1 as its phase counts it, all on the
   tensor-core body), its ladder beside its phase's ladder without
   repair, the term histogram, a fenced run with the repair's own
   ``*/repair`` phase, recall 1.0 and ``.dist`` "same" on the 64 oracle
   queries and every query within 0.002 of its phase's unrepaired answer;
10b. the batched engine with ``scan_impl="xla_deferred"`` at D=10⁶ on
   phase 4's 8192-row database, held to phase 4's streaming answer (its
   rung 1 is K1, counted);
10c. the streaming scan with ``topk_strategy="sort"`` (exact, held to
   phase 4's streaming answer) and ``"binned"`` (approximate: recall ≥
   0.95 against it) on 1024 of phase 4's queries;
10d. ``dtype=bfloat16`` storage at D=10⁶ (uncertified; K1 on the bf16
   storage as its plane): recall with a 50.0 distance tolerance ≥ 0.95
   and the relative distance error < 0.05;
10e. the native host runtime and the CLI on a D=10⁶ file pair: gen-data
   and gen-queries, the native library's file name, its mmap read against
   the NumPy memmap read bit for bit, ``run`` with its host counter table,
   and the counters the host allowed;
11. the CLI in process: gen-data 10⁵ and gen-queries 10³, build-index of
   both kinds, ``run`` of batched, partitioned (from its checkpoint),
   paged (``--resilient``, 16384-row windows), ivf (from its checkpoint),
   sharded and partitioned_sharded (the default mesh: every visible card)
   and batched under ``--profile`` (a Chrome trace), then ``compare`` of
   the exact engines' ``.dist`` files ("same" or "similar");
12. the harness around the engines: (a) ``hvq_tpu_torch.entry.
   dryrun_multichip(4)`` on the card with its capacity leg (D=10⁶:
   ``partitioned_sharded`` at ≥ 16 tiles a shard and the paged engine
   over 4 windows, recall 1.0 both); the full-diff partners' card bytes
   a row at D=10⁶ (batched, partitioned), which must not exceed the
   runner's ``PARTNER_BYTES_PER_ROW``; batched's ids-only fetch against
   its full fetch in turns; (b) the benchmark runner's measuring function
   (``tools.bench.run``) at its default shape, ``partitioned`` over phase
   6's 10⁷ rows (bf16 plane) with phase 7's 4·10⁴ queries: 3 timed runs,
   recall 1.0 and ``.dist`` "same" on 64 oracle queries, and a full diff
   against ``batched`` over every query; (c) ``python -m
   hvq_tpu_torch.tools.bench`` as a subprocess (``batched``, D=10⁶,
   Q=10⁴): exit 0 and its last line, the partner ``partitioned``; (d)
   ``tools.serving_latency`` at D=10⁶, 50 calls at B=1 and B=16 for
   batched and partitioned.

Each phase's seconds are printed as it ends.

Each path runs with the launch counts set to 0 just before it and read
just after; the launches of K1, K3, K2 and K4 are also counted per body,
and every launch of theirs on a main path must run the tensor-core body.
K1 is timed at its five main-path shapes (D=10⁶ fp32, D=10⁷ bf16, the
partitioned window, the paged window, a mesh shard), K3 and K2 at theirs
(D=10⁶, Dt=8192, R=4; K3 also at a mesh shard), K4 at its own, each
beside its bound, its plain version and ``torch.matmul`` of the same bf16
passes alone (product only: not the same function, and the port never
calls it). The level-2 select runs on each K1 stream of phases 4, 6 and 7
(D=10⁶ fp32, D=10⁷ bf16, the partitioned window), held bit for bit to its
plain version (its reduce and the whole select) and timed beside its bound,
one read of the stream; every path's level-2 launches must equal the
engines' level-2 selects (``batched.binned_stream_topk``, counted) and run
the register body. The mesh shards are virtual: all on the one card, so
what a mesh of several cards pays on their links is not measured here. The
last three lines are the card (``nvidia-smi`` name, power limit), a JSON
object describing each kernel (K1–K4, the level-2 select, then each probe
kernel and variant, whose launches are those of phase 3d's timing runs)
with its time, bound and launches, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from hvq_tpu_torch.constants import VEC_DIM  # noqa: E402
from hvq_tpu_torch.models.oracle import search_oracle_batched  # noqa: E402
from hvq_tpu_torch.utils.compare import compare_distances, recall_at_k  # noqa: E402
from hvq_tpu_torch.utils.formats import QuerySet, recompute_result_distances  # noqa: E402
from hvq_tpu_torch.utils.generators import generate_dataset, generate_queries  # noqa: E402
from hvq_tpu_torch.tools import workload  # noqa: E402
from hvq_tpu_torch import get_engine  # noqa: E402
from hvq_tpu_torch.models import batched  # noqa: E402
from hvq_tpu_torch.models.device_db import DeviceDB  # noqa: E402
from hvq_tpu_torch.ops import kernels, probe_kernels, topk  # noqa: E402
from hvq_tpu_torch.ops.distance import require_ieee_fp32  # noqa: E402
from hvq_tpu_torch.ops.masks import query_predicate_fields  # noqa: E402
from hvq_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from hvq_tpu_torch.tools import int8_probe, pallas_probe, v3_anatomy  # noqa: E402
from hvq_tpu_torch.tools.card import (  # noqa: E402
    PEAK_BF16, PEAK_FP32, PEAK_INT8, bound as card_bound, card_line, event_ms)
from hvq_tpu_torch.utils.check import bin_scan_agreement, scan_agreement  # noqa: E402
from hvq_tpu_torch.utils.timing import PhaseTimer  # noqa: E402

DEV = torch.device("cuda")
_LANE_SRC = "hvq_tpu_torch/csrc/lane_scan.cu"
# Each kernel by its wrapper's name (the key of kernels.launches and
# kernels.plain): its source and the TPU kernel's entry function.
KERNELS = {
    "packed_scan_v3": dict(source="hvq_tpu_torch/csrc/packed_scan_v3.cu",
                           replaces="hvq_tpu/ops/pallas_scan.py:1021"),
    "packed_scan": dict(source=_LANE_SRC,
                        replaces="hvq_tpu/ops/pallas_scan.py:633"),
    "packed_scan_v2": dict(source=_LANE_SRC,
                           replaces="hvq_tpu/ops/pallas_scan.py:824"),
    "bin_scan": dict(source=_LANE_SRC,
                     replaces="hvq_tpu/ops/pallas_scan.py:164"),
}
# The kernel each of the engine's kernel scan_impls launches.
IMPL_KERNEL = {"v3": "packed_scan_v3", "v1": "packed_scan", "v2": "packed_scan_v2"}
# The bf16 passes of q·d each lane kernel forms on the fp32 plane, as the
# TPU kernels do: K3 and K4 ask for HIGHEST (K3 for HIGH, which Mosaic
# maps to HIGHEST), the 6-pass bf16 emulation of fp32; K2 the 3-pass split.
LANE_PASSES = {"packed_scan": 6, "packed_scan_v2": 3, "bin_scan": 6}


def log(*a):
    print(*a, flush=True)


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
    """Both libraries at once (one nvcc per object, all started together)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(kernels.build), pool.submit(probe_kernels.build)]:
            job.result()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for mod in (kernels, probe_kernels):
        info = mod.build_info
        log(f"  {os.path.basename(info['path'])}: nvcc {info['seconds']:.2f} s, "
            f"compiled={info['compiled']}")
        for line in info["log"].splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())


def scan_inputs(Vs, C, T, dn, qV, qtype, v, l, r, oid=None):
    """Device tensors of one scan call from host arrays."""
    t = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x)).to(DEV, dt)
    fields = query_predicate_fields(t(qtype, torch.int32), t(v), t(l), t(r))
    if oid is None:
        oid = np.arange(Vs.shape[0])
    return (Vs, C, T, dn, t(oid, torch.int32), t(qV), *fields)


def compare_once(name, args, sn, db_tile, R, **kw):
    """Kernel ``name`` and its plain version on the same inputs; returns
    the agreement and the kernel's output.

    Held to the fp32-plane slack: on the bf16 plane both sides form the
    same exact bf16·bf16 products and differ only in fp32 summation order."""
    kw.update(db_tile=db_tile, bin_top=R)
    got = getattr(kernels, name)(*args, sn, **kw)
    want = kernels.plain[name](*args, sn, **kw)
    torch.cuda.synchronize()
    check = bin_scan_agreement if name == "bin_scan" else scan_agreement
    qV, dn = args[5], args[3]
    agree = check(*got, *want, R, db_tile // 128, (qV * qV).sum(1),
                  float(dn.max()), batched._CERT_REL_MM)
    if not agree["ok"]:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"[Dt={db_tile} R={R} sn={sn} {kw}]: {agree}")
    return agree, got


def small_problem(seed: int, n_pad: int = 65536, B: int = 100):
    rng = np.random.default_rng(seed)
    V = rng.uniform(-6, 6, (n_pad, 128)).astype(np.float32)
    V[:, 100:] = 0.0
    qV = rng.uniform(-6, 6, (B, 128)).astype(np.float32)
    qV[:, 100:] = 0.0
    V[17] = qV[3]                                 # exact duplicate → dist 0
    Vf = torch.from_numpy(V).to(DEV)
    C = torch.from_numpy(rng.integers(0, 4, n_pad).astype(np.float32)).to(DEV)
    T = torch.from_numpy(rng.uniform(-3, 3, n_pad).astype(np.float32)).to(DEV)
    preds = (rng.integers(0, 4, B), rng.integers(0, 4, B).astype(np.float32),
             rng.uniform(-3, 0, B).astype(np.float32),
             rng.uniform(0, 3, B).astype(np.float32))
    return rng, Vf, C, T, (Vf * Vf).sum(1), qV, preds


def k1_vs_plain() -> float:
    """Phase 3, K1: small cases over planes, R, tiles, windows, predicates."""
    _, Vf, C, T, dn, qV, (qtype, v, l, r) = small_problem(5)
    n_pad, B = Vf.shape[0], qV.shape[0]
    worst = 0.0
    for plane in ("fp32", "bf16"):
        Vs = Vf if plane == "fp32" else Vf.to(torch.bfloat16)
        args = scan_inputs(Vs, C, T, dn, qV, qtype, v, l, r)
        cases = [(16384, R, None, None, n_pad) for R in (1, 2, 3, 4, 6, 8, 24)]
        cases += [(1024, R, None, None, 60000) for R in (2, 3, 24, 128)]
        cases += [(1024, 3, 5 * 1024, 7, 60000), (16384, 2, 16384, 2, 50000)]
        for db_tile, R, row0, ntw, sn in cases:
            a, _ = compare_once("packed_scan_v3", args, sn, db_tile, R,
                                row0=row0, ntw=ntw)
            log(f"  K1 vs plain [{plane} Dt={db_tile} R={R} row0={row0} "
                f"ntw={ntw} sn={sn}]: max_abs_err={a['max_abs_err']:.3g} "
                f"tol_ratio={a['tol_ratio']:.3g} same_pos={a['same_pos']:.6f}")
            worst = max(worst, a["max_abs_err"])
    # query 3's exact duplicate (row 17) comes first, at a distance within
    # the matmul slack of 0, and no distance is −0.0 (a negative key)
    args = scan_inputs(Vf, C, T, dn, qV, np.zeros(B), v, l, r)
    for name in ("packed_scan_v3", "packed_scan", "packed_scan_v2"):
        d_k, p_k = getattr(kernels, name)(*args, n_pad, db_tile=1024, bin_top=1)
        i = int(torch.argmin(d_k[3]))
        slack = batched._CERT_REL_MM * 2 * float((args[5][3] ** 2).sum())
        assert int(p_k[3, i]) == 17 and 0.0 <= float(d_k[3, i]) <= slack, name
        assert not torch.signbit(d_k).any(), name
    return worst


def certificate_ratio(dist, true, qn, dn_max: float, rel_mm: float,
                      packed: bool = True) -> float:
    """The largest share of the certificate's slack that kept distances use:

        max (|dist − true| − [packed] 2⁻¹⁶·true) / (rel_mm·(‖q‖² + max‖d‖²))

    over fp64 tensors of the kept distances, their true values and each
    entry's ‖q‖². A packed key's own truncation (2⁻¹⁶·true) is netted out;
    K4's unpacked score s has none, and its distance is s + ‖q‖²."""
    err = (dist - true).abs()
    if packed:
        err = err - 2.0 ** -16 * true
    return float((err / (rel_mm * (qn + dn_max))).max())


def certificate_error(name: str = "packed_scan_v3", Dt: int = 16384, R: int = 3,
                      planes=("fp32", "bf16")) -> dict:
    """Phase 3b: how much of the certificate's slack a scan's arithmetic
    uses.

    For each plane, at unit scale and at the adversarial norms of the
    certificate stress test (data and queries × 64 and × 4096, 64 rows on a
    near-exact sphere around query 0), every finite distance the kernel
    keeps (K1 at Dt = 16384, R = 3; K3 and K2 at their Dt = 8192, R = 4; K4
    at its Dt = 2048, R = 2, score + ‖q‖² in fp64) is held against its true
    value in fp64 from the fp32 data by :func:`certificate_ratio` (rel_mm
    is _CERT_REL_MM on the fp32 plane, _CERT_REL_MM_BF16 on the bf16 plane,
    the slack the engines certify with). The constants assume a
    worst-order fp32 sum with about 2× margin; the ratio must stay ≤ 0.5.
    """
    n_pad, B = 8 * 16384, 256
    rng = np.random.default_rng(33)
    V0 = rng.uniform(-6, 6, (n_pad, 128)).astype(np.float32)
    V0[:, 100:] = 0.0
    q0 = rng.uniform(-6, 6, (B, 128)).astype(np.float32)
    q0[:, 100:] = 0.0
    dirs = rng.standard_normal((64, 100))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    zeros = np.zeros(B)
    out = {}
    rel = {"fp32": batched._CERT_REL_MM, "bf16": batched._CERT_REL_MM_BF16}
    for plane in planes:
        rel_mm, worst = rel[plane], []
        for scale in (1.0, 64.0, 4096.0):
            V, qV = V0 * np.float32(scale), q0 * np.float32(scale)
            radius = 0.1 * scale * (1.0 + 1e-7 * rng.standard_normal((64, 1)))
            V[:64, :100] = (qV[0, :100].astype(np.float64) + radius * dirs).astype(np.float32)
            Vf = torch.from_numpy(V).to(DEV)
            Vs = Vf if plane == "fp32" else Vf.to(torch.bfloat16)
            dn = (Vf * Vf).sum(1)
            args = scan_inputs(Vs, torch.zeros(n_pad, device=DEV), torch.zeros(n_pad, device=DEV),
                               dn, qV, zeros, zeros, zeros, zeros)
            d, p = getattr(kernels, name)(*args, n_pad, db_tile=Dt, bin_top=R)
            fin = torch.isfinite(d)
            qi = torch.nonzero(fin)[:, 0]
            rows = p[fin].long()
            q64, V64 = args[5].double(), Vf.double()
            true = torch.zeros(rows.numel(), dtype=torch.float64, device=DEV)
            for c in range(0, rows.numel(), 1 << 22):
                sl = slice(c, c + (1 << 22))
                true[sl] = ((q64[qi[sl]] - V64[rows[sl]]) ** 2).sum(1)
            qn = (q64 * q64).sum(1)[qi]
            packed = name != "bin_scan"
            dist = d[fin].double() + (0.0 if packed else qn)
            ratio = certificate_ratio(dist, true, qn, float(dn.max()), rel_mm, packed)
            log(f"  {name} certificate error [{plane} scale={scale:g}]: ratio={ratio:.4g} "
                f"max|Δ|={float((dist - true).abs().max()):.4g} "
                f"entries={int(fin.sum())}")
            worst.append(ratio)
            if name == "packed_scan_v3":
                # the same held on what the level-2 select keeps of K1's stream
                top, gids, _ = topk.binned_stream_topk(d, p, 240)
                kept = torch.isfinite(top)
                ki, krows = torch.nonzero(kept)[:, 0], gids[kept].long()
                ktrue = ((q64[ki] - V64[krows]) ** 2).sum(1)
                kqn = (q64 * q64).sum(1)[ki]
                kratio = certificate_ratio(top[kept].double(), ktrue, kqn, float(dn.max()),
                                           rel_mm)
                log(f"  {name} + level2_select certificate error [{plane} scale={scale:g}]: "
                    f"ratio={kratio:.4g} entries={int(kept.sum())}")
                worst.append(kratio)
                del top, gids, kept, ki, krows, ktrue, kqn
            del Vf, Vs, dn, args, d, p, fin, qi, rows, q64, V64, true, dist
        out[plane] = max(worst)
        assert out[plane] <= 0.5, (name, plane, worst)
    torch.cuda.empty_cache()
    return out


def same_bits(a, b) -> bool:
    """Two kernel outputs (fp32 distances or scores, int32 positions or
    ids) are bit-identical."""
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


# The engines' level-2 selects since the last reset_counts(), counted where
# every engine's select_candidates calls them (batched.binned_stream_topk,
# wrapped by main()): each must be one launch of the level-2 kernel.
_level2_selects = [0]


def counting_selects(select):
    def binned_stream_topk(*args, **kw):
        _level2_selects[0] += 1
        return select(*args, **kw)
    return binned_stream_topk


def reset_counts() -> None:
    kernels.reset_launches()
    _level2_selects[0] = 0


def want_level2_launches() -> dict:
    """``kernels.launches`` of a path that launched no scan: one level-2
    launch per select the engines made since :func:`reset_counts`. Asserts
    that each ran the register body (every path selects ``rounds`` ≤ 16)."""
    n = _level2_selects[0]
    assert kernels.level2_body_launches == {"registers": kernels.launches["level2_select"],
                                            "shared": 0}, kernels.level2_body_launches
    return {**dict.fromkeys(kernels.launches, 0), "level2_select": n}


def level2_vs_plain(tag: str, out_s, out_i, kp: int, reps: int = 10) -> dict:
    """The level-2 select on a main path's K1 stream: the kernel's reduce
    (d2, col, worst2) and its whole select (top, ids, worst2) against the
    plain version's bit for bit, the kernel rerun twice bit for bit, then
    the kernel, the plain reduce and both whole selects timed beside the
    bound: one read of the (B, W) fp32 stream at the HBM rate."""
    B, W = out_s.shape
    bins2 = -(-W // 128)
    rounds = min(max(8, -(-kp // bins2)), 128)
    got = kernels.level2_select(out_s, rounds)
    assert same_bits(got, topk.level2_select_plain(out_s, rounds)), f"[{tag}] level2_select"
    for _ in range(2):
        assert same_bits(got, kernels.level2_select(out_s, rounds)), f"[{tag}] rerun differs"
    sel = topk.binned_stream_topk(out_s, out_i, kp)
    assert same_bits(sel, topk.binned_stream_topk_plain(out_s, out_i, kp)), f"[{tag}] select"
    finite = int(torch.isfinite(sel[0]).sum())
    del got, sel
    ms = event_ms(lambda: kernels.level2_select(out_s, rounds), reps)
    plain_ms = event_ms(lambda: topk.level2_select_plain(out_s, rounds), reps)
    select_ms = event_ms(lambda: topk.binned_stream_topk(out_s, out_i, kp), reps)
    plain_select_ms = event_ms(lambda: topk.binned_stream_topk_plain(out_s, out_i, kp), reps)
    bnd = card_bound(0, PEAK_BF16, 4 * B * W)
    log(f"[{tag}] level2_select vs plain at B={B} W={W} rounds={rounds} kp={kp}: "
        f"bit-identical (d2, col, worst2; top, ids, worst2), rerun twice; "
        f"{ms:.3f} ms/call, plain {plain_ms:.3f} ms/call, {bnd}; whole select "
        f"{select_ms:.3f} ms, plain {plain_select_ms:.3f} ms; finite kept {finite}")
    return dict(ms=ms, plain_ms=plain_ms, **bnd, select_ms=select_ms,
                plain_select_ms=plain_select_ms, B=B, W=W, rounds=rounds)


def determinism(name: str = "packed_scan_v3", runs: int = 5) -> int:
    """Phase 3c: a kernel ``runs`` times on the same inputs, bit for bit,
    over both bodies and B=1024. K1 over both planes: 8 tiles of 16384 rows
    (the fp32 shape at R ≤ 3 where a race in the ring once showed: 512
    CTAs, two an SM) and 8-bin tiles. K3 and K2: 8 tiles of 8192 rows at
    R 1–4 and 8 (the lane paths and their rung 1), 8-bin tiles, and R = 32
    on the CUDA-core body. Returns the cases run."""
    if name == "packed_scan_v3":
        n_pad, sn, planes = 8 * 16384, 120000, ("fp32", "bf16")
        shapes = ((16384, 1), (16384, 2), (16384, 3), (16384, 6), (16384, 8),
                  (1024, 3), (1024, 24))
    else:
        n_pad, sn, planes = 8 * 8192, 60000, ("fp32",)
        shapes = ((8192, 1), (8192, 2), (8192, 3), (8192, 4), (8192, 8), (1024, 3),
                  (8192, 32))
    _, Vf, C, T, dn, qV, (qtype, v, l, r) = small_problem(7, n_pad=n_pad, B=1024)
    fn = getattr(kernels, name)
    cases = 0
    for plane in planes:
        Vs = Vf if plane == "fp32" else Vf.to(torch.bfloat16)
        args = scan_inputs(Vs, C, T, dn, qV, qtype, v, l, r)
        for db_tile, R in shapes:
            kw = dict(db_tile=db_tile, bin_top=R)
            first = fn(*args, sn, **kw)
            for _ in range(runs - 1):
                again = fn(*args, sn, **kw)
                if not same_bits(first, again):
                    raise AssertionError(f"{name} is not deterministic [{plane} {kw}]")
            cases += 1
    log(f"  {name} determinism: {cases} cases × {runs} runs bit-identical")
    return cases


def level2_determinism(runs: int = 5) -> int:
    """Phase 3c, the level-2 select: ``runs`` times on the same stream, bit
    for bit, over both bodies and both layouts, at B = 1024 and the
    partitioned window's W (117,120) with tied scores and +inf. Returns the
    cases run."""
    g = torch.Generator(device=DEV).manual_seed(9)
    s = torch.floor(torch.rand((1024, 117120), generator=g, device=DEV) * 16)
    s[torch.rand(s.shape, generator=g, device=DEV) < 0.3] = float("inf")
    cases = 0
    for rounds, layout in ((8, "axis1"), (16, "axis1"), (40, "axis1"), (8, "lane")):
        first = kernels.level2_select(s, rounds, layout)
        for _ in range(runs - 1):
            if not same_bits(first, kernels.level2_select(s, rounds, layout)):
                raise AssertionError(f"level2_select is not deterministic [{rounds} {layout}]")
        cases += 1
    log(f"  level2_select determinism: {cases} cases × {runs} runs bit-identical")
    return cases


def lane_vs_plain() -> dict:
    """Phase 3, K3/K2/K4: R over both bodies, tiles, sample limits, permuted
    oid, ragged query blocks, lanes 112-127; for K4 also emptied bins,
    negative scores and exact ties. Every launch is counted per body."""
    rng, Vf, C, T, dn, qV, (qtype, v, l, r) = small_problem(6)
    n_pad = Vf.shape[0]
    args = scan_inputs(Vf, C, T, dn, qV, qtype, v, l, r)
    perm = rng.permutation(n_pad)
    args_perm = scan_inputs(Vf, C, T, dn, qV, qtype, v, l, r, oid=perm)
    names = ("packed_scan", "packed_scan_v2", "bin_scan")
    worst = dict.fromkeys(names, 0.0)
    bodies = {name: {"wgmma": 0, "simt": 0} for name in names}
    reset_counts()

    def case(name, a, sn, db_tile, R, tag=""):
        agree, got = compare_once(name, a, sn, db_tile, R)
        log(f"  {name} vs plain [Dt={db_tile} R={R} sn={sn}{tag}]: "
            f"max_abs_err={agree['max_abs_err']:.3g} tol_ratio={agree['tol_ratio']:.3g} "
            f"same_pos={agree['same_pos']:.6f} finite={agree['n_finite']}")
        worst[name] = max(worst[name], agree["max_abs_err"])
        bodies[name]["wgmma" if R <= 8 else "simt"] += 1
        return got

    # B = 1000: query blocks of 64 with a ragged last one; 8-bin tiles, so a
    # CTA's 32 bins span four. Then data in lanes 112-127 of the plane and
    # of two queries (the product's 8th k-step; the vectors have 100 lanes).
    _, Vf2, C2, T2, dn2, qV2, (qtype2, v2, l2, r2) = small_problem(8, B=1000)
    args_1000 = scan_inputs(Vf2, C2, T2, dn2, qV2, qtype2, v2, l2, r2)
    high = rng.uniform(-3, 3, (n_pad, 16)).astype(np.float32)
    V_high = Vf.clone()
    V_high[:, 112:] = torch.from_numpy(high).to(DEV)
    q_high = qV.copy()
    q_high[[3, 70], 112:] = 2.5
    args_high = scan_inputs(V_high, C, T, (V_high * V_high).sum(1), q_high, qtype, v, l, r)
    for name in ("packed_scan", "packed_scan_v2"):
        for db_tile in (1024, 8192):
            for R in (1, 2, 3, 4, 8, 32, 128):
                case(name, args, 60000, db_tile, R)
        # the sample mask reads oid: every kept row has oid < sn, and rows at
        # positions ≥ sn are kept
        d, p = case(name, args_perm, 30000, 8192, 4, " oid permuted")
        kept = p[torch.isfinite(d)].long()
        oid = args_perm[4]
        assert bool((oid[kept] < 30000).all()) and bool((kept >= 30000).any()), name
        for R in (3, 8):
            case(name, args_1000, 60000, 1024, R, " B=1000")
        for R in (1, 4):
            case(name, args_high, 60000, 1024, R, " lanes 112-127 in use")
    for db_tile in (128, 2048, 8192):
        for R in (1, 2, 3, 4, 8):
            case("bin_scan", args, 60000, db_tile, R)
    case("bin_scan", args, 60000, 2048, 16)
    for R in (3, 8):
        case("bin_scan", args_1000, 60000, 1024, R, " B=1000")
    for R in (1, 4):
        case("bin_scan", args_high, 60000, 1024, R, " lanes 112-127 in use")
    s, i = case("bin_scan", args_perm, 30000, 2048, 3, " oid permuted")
    assert bool((i[torch.isfinite(s)] < 30000).all())
    # T constant per bin, every query a type-2 range over a tenth of the bin
    # values: whole bins are empty, and their R entries are (+inf, oid of
    # the bin's lane 0)
    Tb = torch.arange(n_pad, device=DEV).div(128, rounding_mode="floor")
    Tb = (Tb % 50).float()
    B = qV.shape[0]
    args_bins = scan_inputs(Vf, C, Tb, dn, qV, np.full(B, 2), v,
                            np.full(B, 10.0), np.full(B, 14.0), oid=perm)
    s, i = case("bin_scan", args_bins, 50000, 2048, 8, " bins emptied")
    row0 = torch.arange(s.shape[1], device=DEV)
    row0 = (row0 // (8 * 16)) * 2048 + (row0 % 16) * 128
    pad = ~torch.isfinite(s)
    assert bool(pad.any())
    assert torch.equal(i[pad], args_bins[4][row0.expand_as(s)[pad]])
    # queries × 3: many kept scores are negative (no ‖q‖², no clamp)
    args_neg = scan_inputs(Vf, C, T, dn, qV * 3, qtype, v, l, r)
    for R in (2, 16):
        s, _ = case("bin_scan", args_neg, 60000, 2048, R, " queries x3")
        assert bool((s < 0).any()), R
    # every bin's lanes 5, 9, 40 and 70 hold query 0: its four scores there
    # tie bit for bit, and the kept ids are those lanes in order
    lanes = [5, 9, 40, 70]
    V_tie = Vf.clone().view(-1, 128, 128)
    V_tie[:, lanes] = torch.from_numpy(qV[0]).to(DEV)
    V_tie = V_tie.view(n_pad, 128)
    zeros = np.zeros(B)
    args_tie = scan_inputs(V_tie, C, T, (V_tie * V_tie).sum(1), qV, zeros, zeros, zeros, zeros)
    g = torch.arange(n_pad // 128, device=DEV).view(-1, 16)
    for R in (3, 4, 16):
        s, i = case("bin_scan", args_tie, n_pad, 2048, R, " exact ties")
        s0, i0 = s[0].view(-1, R, 16), i[0].view(-1, R, 16)
        for j, lane in enumerate(lanes[:R]):
            assert torch.equal(i0[:, j], (g * 128 + lane).int()), (R, j)
            assert torch.equal(s0[:, j].view(torch.int32), s0[:, 0].view(torch.int32)), (R, j)
        assert bool((s0[:, 0] < 0).all())
    assert kernels.lane_body_launches == bodies, (kernels.lane_body_launches, bodies)
    log(f"  lane kernels' launches by body: {bodies}")
    return worst


def bound(rows: int, B: int, W: int, plane_bytes: int, passes: int,
          peak: float) -> dict:
    """The least time the card could take for one packed scan: the larger
    of its operations (``passes`` products of 2·B·rows·VEC_DIM at ``peak``:
    the 100 lanes the vectors have, not the zero padding to 128) and its
    bytes (the 128-lane plane rows as stored, C, T, ‖d‖² and oid of every
    scanned row, the queries and their fields read once, the (B, W) fp32 +
    int32 output written once) at the HBM rate."""
    nbytes = rows * (128 * plane_bytes + 16) + B * (128 * 4 + 24) + B * W * 8
    return card_bound(passes * 2.0 * B * rows * VEC_DIM, peak, nbytes)


def k1_bound(Vs, B, W, rows) -> dict:
    """K1's bound: one bf16 pass on the bf16 plane, three on the fp32 plane."""
    bf16 = Vs.dtype == torch.bfloat16
    return bound(rows, B, W, 2 if bf16 else 4, 1 if bf16 else 3, PEAK_BF16)


def lane_bound(name: str, rows: int, B: int, W: int) -> dict:
    """The bound of a lane kernel on the fp32 plane: its bf16 passes
    (``LANE_PASSES``) at the bf16 tensor-core peak; for the six-pass K3 and
    K4 also ``bound_fp32_simt_ms``, one IEEE fp32 pass on the CUDA cores
    (67 TFLOP/s), the figure their bound was given before their arithmetic
    was read as the TPU kernels'."""
    out = bound(rows, B, W, 4, LANE_PASSES[name], PEAK_BF16)
    if LANE_PASSES[name] == 6:
        out["bound_fp32_simt_ms"] = bound(rows, B, W, 4, 1, PEAK_FP32)["bound_ms"]
    return out


def probe_bounds() -> dict:
    """The bounds of the three TPU measurement scripts in ``experiments/``
    that reach ``pl.pallas_call`` (on no path of the system; each has its
    tool in ``hvq_tpu_torch/tools/``, whose own bounds at these variants
    the CPU tests hold equal to these), from the shapes in those scripts,
    by the rule of :func:`bound`. Their arrays carry data in all 128
    lanes, so the operations count 128:

    * ``pallas_probe.py:32`` ``_trivial``: x·2 on a (256, 128) fp32 array;
    * ``int8_probe.py:83``: (256, 128) · (128, 16384) over 61 tiles, each
      product's min over 128-column bins written as (61, 256, 128) 4-byte
      values; bf16 inputs at the bf16 peak, int8 at the int8 peak;
    * ``v3_anatomy.py:189``: K1's stages at B = 1024 over 61 tiles of 16384
      rows; the whole kernel at R = 2, three bf16 passes on the fp32 plane
      and one on the bf16 plane."""
    n = 256 * 128
    out = {"pallas_probe:32 _trivial": card_bound(n, PEAK_FP32, 2 * n * 4)}
    B, Dt, nt = 256, 16384, 61
    for dtype, size, peak in (("bf16", 2, PEAK_BF16), ("int8", 1, PEAK_INT8)):
        nbytes = (B + nt * Dt) * 128 * size + nt * B * 128 * 4
        out[f"int8_probe:83 {dtype}"] = card_bound(2 * B * 128 * Dt * nt, peak, nbytes)
    B, rows, R = 1024, nt * Dt, 2
    for plane, size, passes in (("fp32", 4, 3), ("bf16", 2, 1)):
        nbytes = rows * (128 * size + 16) + B * (2 * 128 * 2 + 24) + B * nt * R * 128 * 4
        out[f"v3_anatomy:189 {plane}"] = card_bound(passes * 2 * B * rows * 128, PEAK_BF16,
                                                    nbytes)
    return out


def anatomy_small() -> dict:
    """Phase 3d: the K1 anatomy on small cases against its plain version.
    Every stage on every plane at R 1–4 with B = 100 and at R 2 with B =
    1000 (a ragged query block), over three 1024-row tiles (8 bins a tile,
    a CTA's bin block ragged), mixed predicates, a sample limit (the last
    200 rows) and one bin, bin 3 of tile 1, whose rows are all past it;
    mmc512 at R 1; mm and full R 2 over two 16384-row tiles. Returns the
    largest |Δ| by launch key."""
    worst: dict = {}

    def case(stage, R, plane, args, db_tile):
        err = v3_anatomy.agreement(stage, plane, R, args, db_tile)
        key = f"k1_anatomy {plane} {stage} R{R}"
        worst[key] = max(worst.get(key, 0.0), err)

    for B, n_pad, db_tile in ((100, 3 * 1024, 1024), (1000, 3 * 1024, 1024),
                              (100, 2 * 16384, 16384)):
        _, Vf, C, T, dn, qV, (qtype, v, l, r) = small_problem(11, n_pad=n_pad, B=B)
        oid = np.arange(n_pad)
        masked_bin = 1024 + 8 * np.arange(128) + 3
        oid[masked_bin] += n_pad
        sn = n_pad - 200
        planes = dict(fp32=Vf, bf16=Vf.to(torch.bfloat16), int8=probe_kernels.quantize_i8(Vf))
        for plane, Vs in planes.items():
            args = (*scan_inputs(Vs, C, T, dn, qV, qtype, v, l, r, oid=oid), sn)
            if db_tile == 16384:
                cases = [("mm", 1), ("full", 2)]
            else:
                Rs = (1, 2, 3, 4) if B == 100 else (2,)
                cases = [(stage, R) for stage in probe_kernels.STAGES for R in Rs]
                if plane == "bf16" and B == 100:
                    cases.append(("mmc512", 1))
            for stage, R in cases:
                case(stage, R, plane, args, db_tile)
            if db_tile == 1024 and B == 100:
                # the masked bin's keys are all +inf: 0x7F800000, no payload
                out = probe_kernels.k1_anatomy(*args, stage="full", db_tile=1024, bin_top=3)
                col = 1 * 3 * 8 + np.arange(3) * 8 + 3
                assert bool((out[:, col] == 0x7F800000).all()), plane
    log(f"  k1_anatomy vs plain: {len(worst)} variants on small cases, max |Δ| "
        f"{max(worst.values()):.3g}")
    return worst


def int8_probe_small() -> dict:
    """Phase 3d: the int8 probe's variants against their plain versions at
    B 100, 256 and 1000 (ragged query blocks) over 2–3 tiles of 1024 or
    2048 columns; returns the largest |Δ| by launch key."""
    worst: dict = {}
    for b, nt, dt in ((100, 2, 1024), (256, 3, 2048), (1000, 2, 1024)):
        data = int8_probe.inputs(seed=b, b=b, dt=dt, nt=nt, sets=1)
        for variant in int8_probe.VARIANTS:
            qs, d = int8_probe.operands(data, variant)
            key = f"int8_probe {variant}"
            worst[key] = max(worst.get(key, 0.0), int8_probe.agreement(variant, qs[0], d))
    log(f"  int8_probe vs plain: {worst}")
    return worst


def probe_phase(library_path: str) -> list:
    """Phase 3d: the TPU probe kernels. Small cases, then each tool's
    check at its script's shape, then the tools' timing runs with the probe
    counts reset just before and read just after; returns the kernels
    line's entries of the probe kernels."""
    worst = anatomy_small()
    worst.update(int8_probe_small())
    # odd sizes (a scalar tail after the 16-byte body) and a view 4 bytes
    # off alignment (the one-value-a-thread kernel)
    for x in (torch.randn(1001, device=DEV), torch.randn(1003, device=DEV)[1:]):
        assert torch.equal(probe_kernels.trivial(x).view(torch.int32), (x * 2).view(torch.int32))
    worst["trivial"] = pallas_probe.trivial_check()["max_abs_err"]

    anat = v3_anatomy.inputs()
    for name, err in v3_anatomy.check(anat).items():
        key = next(f"k1_anatomy {p} {s} R{R}" for n, s, R, p in v3_anatomy.ALL_SPECS if n == name)
        worst[key] = max(worst.get(key, 0.0), err)
    i8 = int8_probe.inputs()
    for variant, err in int8_probe.check(i8).items():
        key = f"int8_probe {variant}"
        worst[key] = max(worst[key], err)
    k3 = pallas_probe.k3_check()
    log(f"  pallas_probe K3 check: {k3}")

    torch.cuda.synchronize()
    probe_kernels.reset_launches()
    t_anat = v3_anatomy.measure(anat)
    t_i8 = int8_probe.measure(i8)
    t_triv = pallas_probe.trivial_time()
    torch.cuda.synchronize()
    counts = dict(probe_kernels.launches)
    log(f"  probe launches in the timing runs: {counts}")
    del anat, i8
    torch.cuda.empty_cache()
    return probe_entries(t_anat, t_i8, t_triv, k3, counts, worst, library_path)


def probe_entries(t_anat: dict, t_i8: dict, t_triv: dict, k3: dict, counts: dict,
                  worst: dict, library_path: str) -> list:
    """The kernels line's entries of the probe kernels from the tools'
    timing runs (``v3_anatomy.measure``, ``int8_probe.measure``,
    ``pallas_probe.trivial_time``), their launch counts in those runs and
    the small cases' worst errors."""
    def entry(name, source, replaces, r, **extra):
        assert counts.get(name, 0) >= 1, (name, counts)
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    library=library_path, launches=counts[name], max_abs_err=worst[name],
                    ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], **extra)

    entries = []
    for name, stage, R, plane in v3_anatomy.ALL_SPECS:
        key = f"k1_anatomy {plane} {stage} R{R}"
        entries.append(entry(key, v3_anatomy.SOURCE, v3_anatomy.REPLACES, t_anat[name],
                             variant=name, library_ms=None))
    for variant in int8_probe.VARIANTS:
        r = t_i8[variant]
        entries.append(entry(f"int8_probe {variant}", int8_probe.SOURCE, int8_probe.REPLACES,
                             r, library_ms=None, product_only_ms=r["product_only_ms"],
                             **({"transpose_only_ms": r["transpose_only_ms"]}
                                if "transpose_only_ms" in r else {})))
    # ms / library_ms: CUDA events; host_us: the host clock, µs a call (the
    # launch path's steps in launch_path_us); device_ms: the profiler's
    # kernel duration
    entries.append(entry("trivial", pallas_probe.SOURCE, pallas_probe.REPLACES, t_triv,
                         library_ms=t_triv["library_ms"], device_ms=t_triv["device_ms"],
                         host_us=t_triv["host_us"],
                         library_device_ms=t_triv["library_device_ms"],
                         library_host_us=t_triv["library_host_us"],
                         launch_path_us=t_triv["launch_path_us"], k3_check=k3))
    return entries


# (query part, plane part) of each bf16 pass, parts 0 = hi, 1 = next, 2 =
# last: the kernels' chains (csrc/scan_wgmma.cuh).
CHAINS = {1: ((0, 0),), 3: ((0, 0), (0, 1), (1, 0)),
          6: ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))}


def bf16_parts(x, n: int) -> list:
    """The n-way bf16 split of an fp32 tensor: bf16_rn(x), then the bf16
    rounding of each remainder."""
    parts, rest = [], x
    for _ in range(n):
        parts.append(rest.to(torch.bfloat16))
        rest = rest - parts[-1].float()
    return parts


def product_only_ms(Vs, qV, row0: int, rows: int, passes: int, reps: int = 3) -> float:
    """``torch.matmul`` of a kernel's bf16 passes alone over rows [row0,
    row0 + rows): one pass on the bf16 plane (K1); on the fp32 plane the 3
    split passes (K1, K2) or the 6 passes of the three-way split (K3), in
    chunks of 2²⁰ rows (bf16 outputs, not kept). Product only: a yardstick,
    not the same function, and the port never calls it."""
    step = 1 << 20
    n = {1: 1, 3: 2, 6: 3}[passes]
    qp = bf16_parts(qV, n)
    if Vs.dtype == torch.bfloat16:
        chunks = [(Vs[r:r + step],) for r in range(row0, row0 + rows, step)]
    else:
        chunks = [bf16_parts(Vs[r:r + step], n) for r in range(row0, row0 + rows, step)]

    def run():
        for c in chunks:
            for i, j in CHAINS[passes]:
                torch.matmul(qp[i], c[j].t())
    ms = event_ms(run, reps)
    del chunks
    return ms


def first_batch(qs, B):
    """(qV (B, 128), predicate fields) of the first B queries, on the card."""
    Qp = batched.pack_query_block(qs.V[:B], qs.qtype[:B], qs.v[:B], qs.l[:B],
                                  qs.r[:B])
    qV = torch.zeros((B, 128), device=DEV)
    qV[:, :100] = torch.from_numpy(Qp[:, :100]).to(DEV)
    fields = query_predicate_fields(*(torch.from_numpy(Qp[:, 100 + j].copy()).to(DEV)
                                      for j in range(4)))
    return qV, fields


def references(tag, ds, qs, db) -> dict:
    """The 64-query oracle answer and every query's streaming-path answer."""
    t0 = time.perf_counter()
    sub = QuerySet(qtype=qs.qtype[:64], v=qs.v[:64], l=qs.l[:64], r=qs.r[:64],
                   V=qs.V[:64])
    oids, odists = search_oracle_batched(ds, sub)
    log(f"[{tag}] oracle, 64 queries: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stream = get_engine("batched")(ds, device=DEV, device_db=db, scan_impl="stream")
    s_ids, _ = stream.search(qs)
    s_d = recompute_result_distances(ds, qs, s_ids.astype(np.int64))
    log(f"[{tag}] stream path, all {qs.m} queries: {time.perf_counter() - t0:.1f} s")
    return dict(sub=sub, oids=oids, odists=odists,
                oracle_d=recompute_result_distances(ds, sub, oids.astype(np.int64)),
                stream_d=s_d)


def run_engine(tag, eng, ds, qs, ref, seed) -> dict:
    """One engine's main path: its kernel at the main-path shape, warm-up,
    the timed search with its launch counts, a fenced phase run, and the
    oracle and streaming checks."""
    db, B, n = eng.db, eng.query_batch, ds.n
    name = IMPL_KERNEL[eng.scan_impl]
    log(f"[{tag}] engine: n_pad={db.n_pad} db_tile={db.db_tile} R={eng.bin_top} "
        f"k'={eng.kprime} B={B} scan_impl={eng.scan_impl} layout={eng.scan_layout} "
        f"certified={eng.certified}")
    assert eng.certified

    # the kernel against its plain version at the main-path shape
    qV, fields = first_batch(qs, B)
    plane = db.scan_V if name == "packed_scan_v3" else db.Vp
    args = (plane, db.C, db.T, db.d_norms, eng._pos, qV, *fields, n)
    kw = dict(db_tile=db.db_tile, bin_top=eng.bin_top)
    got = getattr(kernels, name)(*args, **kw)
    want = kernels.plain[name](*args, **kw)
    agree = scan_agreement(*got, *want, eng.bin_top, db.db_tile // 128,
                           (qV * qV).sum(1), eng._dn_max, eng._rel_mm)
    del want
    log(f"[{tag}] {name} vs plain at B={B}: {agree}")
    assert agree["ok"], agree
    for _ in range(2):
        assert same_bits(got, getattr(kernels, name)(*args, **kw)), f"{name} rerun differs"
    log(f"[{tag}] {name} rerun twice: bit-identical")
    # the level-2 select on this stream: K1's paths select through it
    level2 = level2_vs_plain(tag, *got, eng.kprime) if name == "packed_scan_v3" else None
    del got
    reps = 10 if n <= 2_000_000 else 3
    ms = event_ms(lambda: getattr(kernels, name)(*args, **kw), reps)
    plain_ms = event_ms(lambda: kernels.plain[name](*args, **kw), reps)
    W = db.n_pad * eng.bin_top // 128
    if name == "packed_scan_v3":
        bnd = k1_bound(plane, B, W, db.n_pad)
        passes = 1 if plane.dtype == torch.bfloat16 else 3
    else:
        bnd = lane_bound(name, db.n_pad, B, W)
        passes = LANE_PASSES[name]
    bnd["product_only_matmul_ms"] = product_only_ms(plane, qV, 0, db.n_pad, passes)
    log(f"[{tag}] {name} {ms:.3f} ms/call, plain {plain_ms:.3f} ms/call, {bnd} "
        f"(B={B}, Dt={db.db_tile}, R={eng.bin_top}, n_pad={db.n_pad})")

    # warm-up, then the timed main path with the launch counts around it
    eng.search(generate_queries(B, seed=seed + 2, categories=workload.CATEGORIES))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ids, dists = eng.search(qs)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    bodies = dict(kernels.k1_body_launches)
    lane_bodies = {k: dict(v) for k, v in kernels.lane_body_launches.items()}
    ladder = dict(eng.last_ladder)
    log(f"[{tag}] search {qs.m} queries: {wall:.3f} s = {qs.m / wall:.1f} QPS; "
        f"launches {launches}; K1 bodies {bodies}; K3/K2 bodies {lane_bodies}; "
        f"ladder {ladder}")
    # every K1, K3 and K2 launch of the path (R ≤ 8, rung 1 at 2R ≤ 8) is
    # tensor-core
    assert bodies == {"wgmma": launches["packed_scan_v3"], "simt": 0}, bodies
    for k, v in lane_bodies.items():
        assert v == {"wgmma": launches[k], "simt": 0}, lane_bodies
    want_launches = want_level2_launches()
    want_launches[name] += -(-qs.m // B)
    # rung 1 is the packed scan in scan_layout: K1 for axis1, K2 for lane
    rung1 = "packed_scan_v3" if eng.scan_layout == "axis1" else "packed_scan_v2"
    want_launches[rung1] += ladder.get("rung1_runs", 0)
    assert launches == want_launches, (launches, want_launches)
    if ladder["suspects"]:
        assert ladder["rung1_runs"] >= 1
        assert ladder["rung1_bin_top"] == 2 * eng.bin_top, ladder
    assert ids.shape == (qs.m, 100) and dists.shape == (qs.m, 100)
    assert np.isfinite(dists).all() and (ids < n).all()

    phases = PhaseTimer(device=DEV)
    eng.search(qs, phases=phases)
    log(f"[{tag}] phases (fenced run): {json.dumps(phases.as_dict())}")

    sub = ref["sub"]
    rec = recall_at_k(ids[:64], ref["oids"], dists[:64], ref["odists"])
    res = compare_distances(
        recompute_result_distances(ds, sub, ids[:64].astype(np.int64)),
        ref["oracle_d"])
    log(f"[{tag}] oracle (64 queries): recall@100={rec} dist={res.status} "
        f"max|Δ|={res.max_abs_diff}")
    assert rec == 1.0 and res.ok, (rec, res)
    full = compare_distances(
        recompute_result_distances(ds, qs, ids.astype(np.int64)), ref["stream_d"])
    log(f"[{tag}] vs stream path, all {qs.m} queries: {full.status} "
        f"max|Δ|={full.max_abs_diff} beyond={full.num_exceeding}")
    assert full.ok, full
    return dict(name=name, qps=qs.m / wall, ms=ms, plain_ms=plain_ms, **bnd,
                launches=launches, bodies=bodies, lane_bodies=lane_bodies,
                max_abs_err=agree["max_abs_err"], suspects=ladder["suspects"],
                ladder=ladder, ids=ids, level2=level2)


def k4_path(tag, db, qs) -> dict:
    """K4 at B=1024 over the database's rows with its own defaults (Dt=2048,
    R=2): one counted call, on the tensor-core body, held to its plain
    version and rerun twice bit for bit, then timed beside its plain
    version, its bound and the six bf16 passes' product alone."""
    B, R, Dt = 1024, 2, 2048
    name = "bin_scan"
    qV, fields = first_batch(qs, B)
    pos = torch.arange(db.n_pad, dtype=torch.int32, device=DEV)
    args = (db.Vp, db.C, db.T, db.d_norms, pos, qV, *fields, db.n)
    kw = dict(db_tile=Dt, bin_top=R)
    reset_counts()
    got = kernels.bin_scan(*args, **kw)
    torch.cuda.synchronize()
    launches = kernels.launches[name]
    bodies = dict(kernels.lane_body_launches[name])
    want = kernels.plain[name](*args, **kw)
    agree = bin_scan_agreement(*got, *want, R, Dt // 128, (qV * qV).sum(1),
                               float(db.d_norms.max()), batched._CERT_REL_MM)
    del want
    log(f"[{tag}] {name} vs plain at B={B}: {agree}; launches {launches}, bodies {bodies}")
    assert agree["ok"] and launches == 1, (agree, launches)
    assert bodies == {"wgmma": 1, "simt": 0}, bodies
    for _ in range(2):
        assert same_bits(got, kernels.bin_scan(*args, **kw)), f"{name} rerun differs"
    del got
    log(f"[{tag}] {name} rerun twice: bit-identical")
    ms = event_ms(lambda: kernels.bin_scan(*args, **kw), 10)
    plain_ms = event_ms(lambda: kernels.plain[name](*args, **kw), 10)
    bnd = lane_bound(name, db.n_pad, B, db.n_pad * R // 128)
    bnd["product_only_matmul_ms"] = product_only_ms(db.Vp, qV, 0, db.n_pad,
                                                    LANE_PASSES[name])
    log(f"[{tag}] {name} {ms:.3f} ms/call, plain {plain_ms:.3f} ms/call, {bnd} "
        f"(B={B}, Dt={Dt}, R={R}, n_pad={db.n_pad})")
    return dict(ms=ms, plain_ms=plain_ms, **bnd, launches=launches, bodies=bodies,
                max_abs_err=agree["max_abs_err"])


def dataset(n: int, seed: int, tag: str):
    t0 = time.perf_counter()
    ds, qs = workload.mixed(n, seed)
    log(f"[{tag}] data {time.perf_counter() - t0:.1f} s")
    return ds, qs


def paths_d1e6(seed: int = 100):
    """Phases 4–5: K1, K3 and K2 engines and K4 over one D=10⁶ dataset.
    Returns their results, what phase 9b reuses (the dataset, queries and
    references) and the 8192-row database phase 10 reuses."""
    tag = "D=1e+06 fp32"
    ds, qs = dataset(1_000_000, seed, tag)
    out = {}
    eng = get_engine("batched")(ds, device=DEV, scan_store="fp32")
    assert eng.scan_impl == "v3"
    ref = references(tag, ds, qs, eng.db)
    out["v3"] = run_engine(f"{tag} v3", eng, ds, qs, ref, seed)
    del eng, out["v3"]["ids"]
    lane_db = DeviceDB.from_dataset(ds, db_tile=8192, device=DEV)
    for impl in ("v1", "v2"):
        eng = get_engine("batched")(ds, device=DEV, scan_impl=impl,
                                    device_db=lane_db)
        assert eng.db.db_tile == 8192 and eng.bin_top == 4
        out[impl] = run_engine(f"{tag} {impl}", eng, ds, qs, ref, seed)
        del eng, out[impl]["ids"]
    out["k4"] = k4_path(tag, lane_db, qs)
    return out, (ds, qs, ref), lane_db


def path_d1e7(seed: int = workload.PARTITIONED_SEED):
    """Phase 6: K1 on the bf16 plane at D=10⁷. Returns its result and what
    phases 7 and 8 reuse: the dataset, queries, engine, oracle answer and
    the engine's ids for every query."""
    tag = "D=1e+07 bf16"
    ds, qs = dataset(workload.PARTITIONED_ROWS, seed, tag)
    eng = get_engine("batched")(ds, device=DEV, scan_store="bf16")
    assert eng.scan_impl == "v3"
    ref = references(tag, ds, qs, eng.db)
    r = run_engine(tag, eng, ds, qs, ref, seed)
    return r, (ds, qs, eng, ref, r.pop("ids"))


def window_vs_plain(tag, eng, qs) -> dict:
    """K1 on one windowed batch of the timed search (the batch's own
    query_batch wide type-2 queries, its row0/ntw over the time view, the
    view's permuted oid) against its plain version, then both timed."""
    row0, ntw, sel = eng.last_windows[0]
    tv, B = eng.index.time_view, eng.query_batch
    qV, fields = first_batch(QuerySet(qtype=qs.qtype[sel], v=qs.v[sel], l=qs.l[sel],
                                      r=qs.r[sel], V=qs.V[sel]), B)
    args = (tv.scan_V, tv.C, tv.T, tv.d_norms, tv.oid, qV, *fields, tv.n)
    kw = dict(db_tile=tv.db_tile, bin_top=eng.bin_top, row0=row0, ntw=ntw)
    got = kernels.packed_scan_v3(*args, **kw)
    want = kernels.plain["packed_scan_v3"](*args, **kw)
    agree = scan_agreement(*got, *want, eng.bin_top, tv.db_tile // 128,
                           (qV * qV).sum(1), eng._dn_max, eng._rel_mm)
    del want
    pos = got[1]
    assert int(pos.min()) >= row0 and int(pos.max()) < row0 + ntw * tv.db_tile
    log(f"[{tag}] K1 window vs plain (row0={row0} ntw={ntw} of {tv.num_tiles} "
        f"tiles, B={B}): {agree}")
    assert agree["ok"], agree
    for _ in range(2):
        assert same_bits(got, kernels.packed_scan_v3(*args, **kw)), "K1 window rerun differs"
    log(f"[{tag}] K1 window rerun twice: bit-identical")
    level2 = level2_vs_plain(f"{tag} window", *got, eng.kprime, reps=3)
    del got, pos
    ms = event_ms(lambda: kernels.packed_scan_v3(*args, **kw), 3)
    plain_ms = event_ms(lambda: kernels.plain["packed_scan_v3"](*args, **kw), 3)
    rows = ntw * tv.db_tile
    bnd = k1_bound(tv.scan_V, B, rows * eng.bin_top // 128, rows)
    bnd["product_only_matmul_ms"] = product_only_ms(tv.scan_V, qV, row0, rows, 1)
    log(f"[{tag}] K1 window {ms:.3f} ms/call, plain {plain_ms:.3f} ms/call, {bnd}")
    return dict(ms=ms, plain_ms=plain_ms, **bnd, max_abs_err=agree["max_abs_err"],
                level2=level2)


def path_partitioned(reused, seed: int = workload.PARTITIONED_SEED) -> dict:
    """Phase 7: the partitioned engine over phase 6's rows and queries."""
    ds, qs6, partner, ref, _ = reused
    tag = "D=1e+07 bf16 partitioned"
    qs = workload.partitioned_queries(qs6, seed)
    t0 = time.perf_counter()
    eng = get_engine("partitioned")(ds, device=DEV, scan_store="bf16")
    log(f"[{tag}] engine built in {time.perf_counter() - t0:.1f} s "
        f"(index {eng.index.build_seconds}); n_pad={eng.index.cat_view.n_pad} "
        f"db_tile={eng.index.cat_view.db_tile} R={eng.bin_top} k'={eng.kprime} "
        f"B={eng.query_batch} caps={eng.route_buckets} scan_impl={eng.scan_impl} "
        f"time_view_max_bytes={eng.time_view_max_bytes}")
    assert eng.scan_impl == "v3" and eng.certified and eng.kprime == 240
    # warm-up over the whole set: it builds the time view
    t0 = time.perf_counter()
    eng.search(qs)
    torch.cuda.synchronize()
    log(f"[{tag}] warm-up search {time.perf_counter() - t0:.1f} s; "
        f"route {eng.last_route}; time view built in "
        f"{eng.index.build_seconds.get('time_view', float('nan')):.1f} s")
    assert eng.index._time_view is not None
    reset_counts()
    t0 = time.perf_counter()
    ids, dists = eng.search(qs)
    wall = time.perf_counter() - t0
    launches, route = dict(kernels.launches), dict(eng.last_route)
    bodies = dict(kernels.k1_body_launches)
    lane_bodies = {k: dict(v) for k, v in kernels.lane_body_launches.items()}
    log(f"[{tag}] search {qs.m} queries: {wall:.3f} s = {qs.m / wall:.1f} QPS; "
        f"launches {launches}; K1 bodies {bodies}; route {json.dumps(route)}")
    windowed = sum(route["windowed_batches"].values())
    want_launches = want_level2_launches()
    want_launches["packed_scan_v3"] = (route["full_batches"] + windowed
                                       + route["ladder"].get("rung1_runs", 0))
    assert launches == want_launches, (launches, want_launches)
    # all of them (rung 1 at 2R = 6 included) on the tensor-core body
    assert bodies == {"wgmma": want_launches["packed_scan_v3"], "simt": 0}, bodies
    assert windowed >= 1 and sum(route["routed_groups"].values()) >= 1, route
    assert ids.shape == (qs.m, 100) and np.isfinite(dists).all() and (ids < ds.n).all()
    win = window_vs_plain(tag, eng, qs)

    phases = PhaseTimer(device=DEV)
    eng.search(qs, phases=phases)
    log(f"[{tag}] phases (fenced run): {json.dumps(phases.as_dict())}")

    sub = ref["sub"]
    rec = recall_at_k(ids[:64], ref["oids"], dists[:64], ref["odists"])
    res = compare_distances(
        recompute_result_distances(ds, sub, ids[:64].astype(np.int64)),
        ref["oracle_d"])
    log(f"[{tag}] oracle (64 queries): recall@100={rec} dist={res.status} "
        f"max|Δ|={res.max_abs_diff}")
    assert rec == 1.0 and res.ok, (rec, res)
    index = eng.index           # phase 10 searches it again, repaired
    del eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p_ids, _ = partner.search(qs)
    full = compare_distances(
        recompute_result_distances(ds, qs, ids.astype(np.int64)),
        recompute_result_distances(ds, qs, p_ids.astype(np.int64)))
    log(f"[{tag}] vs the batched K1 engine, all {qs.m} queries "
        f"({time.perf_counter() - t0:.1f} s): {full.status} "
        f"max|Δ|={full.max_abs_diff} beyond={full.num_exceeding}")
    assert full.ok, full
    return dict(qps=qs.m / wall, launches=launches, bodies=bodies,
                lane_bodies=lane_bodies, route=route, window=win,
                max_abs_err=win["max_abs_err"], ids=ids, index=index)


def paged_window_vs_plain(tag, eng, qs) -> dict:
    """K1 on the paged engine's first window (its own upload, outside the
    counted search: global ``oid``, padding rows n) at B = query_batch
    against its plain version, then both timed beside the bound."""
    w0, wlen = eng.windows[0]
    Vw, Vs, Cw, Tw, dnw, oidw = eng._upload_window(w0, wlen)
    B, rows = eng.query_batch, Vw.shape[0]
    qV, fields = first_batch(qs, B)
    args = (Vs, Cw, Tw, dnw, oidw, qV, *fields, eng.ds.n)
    kw = dict(db_tile=eng.db_tile, bin_top=eng.bin_top)
    got = kernels.packed_scan_v3(*args, **kw)
    want = kernels.plain["packed_scan_v3"](*args, **kw)
    agree = scan_agreement(*got, *want, eng.bin_top, eng.db_tile // 128,
                           (qV * qV).sum(1), float(dnw.max()), eng._rel_mm)
    del want
    log(f"[{tag}] K1 paged window vs plain (rows={rows}, B={B}, R={eng.bin_top}): {agree}")
    assert agree["ok"], agree
    for _ in range(2):
        assert same_bits(got, kernels.packed_scan_v3(*args, **kw)), "K1 paged rerun differs"
    del got
    ms = event_ms(lambda: kernels.packed_scan_v3(*args, **kw), 3)
    plain_ms = event_ms(lambda: kernels.plain["packed_scan_v3"](*args, **kw), 3)
    bnd = k1_bound(Vs, B, rows * eng.bin_top // 128, rows)
    bnd["product_only_matmul_ms"] = product_only_ms(Vs, qV, 0, rows, 3)
    log(f"[{tag}] K1 paged window {ms:.3f} ms/call, plain {plain_ms:.3f} ms/call, {bnd}")
    del Vw, Vs, Cw, Tw, dnw, oidw, args
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, **bnd, max_abs_err=agree["max_abs_err"])


# Phase 8's requested window: rounded down to whole 16384-row tiles.
PAGED_WINDOW_ROWS = 2_500_000


def path_paged(ds, qs, ref, batched_ids) -> dict:
    """Phase 8: the paged engine over phase 6's host rows and queries on
    the fp32 plane, five windows of 2,490,368 rows (the last 38,528)."""
    tag = "D=1e+07 fp32 paged"
    free = torch.cuda.mem_get_info(DEV)[0]
    derived = get_engine("paged")(ds, device=DEV)
    log(f"[{tag}] default window on this card ({free} bytes free): "
        f"window_rows={derived.window_rows} windows={len(derived.windows)} "
        f"R={derived.bin_top}")
    del derived
    eng = get_engine("paged")(ds, device=DEV, window_rows=PAGED_WINDOW_ROWS)
    log(f"[{tag}] engine: window_rows={eng.window_rows} windows={eng.windows} "
        f"db_tile={eng.db_tile} R={eng.bin_top} k'={eng.kprime} B={eng.query_batch} "
        f"scan_impl={eng.scan_impl}")
    wr = PAGED_WINDOW_ROWS - PAGED_WINDOW_ROWS % eng.db_tile    # 2,490,368 at 16384
    nw = -(-ds.n // wr)                                        # 5 at D=10⁷
    assert eng.window_rows == wr and len(eng.windows) == nw
    assert eng.windows[-1][1] == ds.n - (nw - 1) * wr          # 38,528 at D=10⁷
    assert eng.scan_impl == "v3" and eng.kprime == 128 and eng.certified
    win = paged_window_vs_plain(tag, eng, qs)
    uploads = []
    upload = eng._upload_window
    eng._upload_window = lambda w0, wlen: uploads.append(w0) or upload(w0, wlen)
    t0 = time.perf_counter()
    eng.search(generate_queries(eng.query_batch, seed=3, categories=workload.CATEGORIES))
    torch.cuda.synchronize()
    log(f"[{tag}] warm-up search {time.perf_counter() - t0:.1f} s "
        f"(pays the ‖d‖² bound over every row, {eng._dn_max_bound()})")
    uploads.clear()
    reset_counts()
    t0 = time.perf_counter()
    ids, dists = eng.search(qs)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    bodies = dict(kernels.k1_body_launches)
    lane_bodies = {k: dict(v) for k, v in kernels.lane_body_launches.items()}
    reruns = dict(eng.last_reruns)
    log(f"[{tag}] search {qs.m} queries: {wall:.3f} s = {qs.m / wall:.1f} QPS; "
        f"launches {launches}; K1 bodies {bodies}; uploads {uploads}; reruns {reruns}")
    want = want_level2_launches()
    want["packed_scan_v3"] = len(eng.windows) * -(-qs.m // eng.query_batch)
    assert launches == want, (launches, want)
    assert bodies == {"wgmma": want["packed_scan_v3"], "simt": 0}, bodies
    assert uploads == [w0 for w0, _ in eng.windows], uploads
    assert ids.shape == (qs.m, 100) and np.isfinite(dists).all() and (ids < ds.n).all()

    phases = PhaseTimer(device=DEV)
    eng.search(qs, phases=phases)
    ph = phases.as_dict()
    up_gb = ds.n * ds.V.shape[1] * 4 / 1e9
    rate = up_gb / (ph["search/window_upload"]["ms"] / 1e3)
    log(f"[{tag}] phases (fenced run): {json.dumps(ph)}; window upload "
        f"{up_gb:.3f} GB of vectors at {rate:.2f} GB/s")

    sub = ref["sub"]
    rec = recall_at_k(ids[:64], ref["oids"], dists[:64], ref["odists"])
    res = compare_distances(
        recompute_result_distances(ds, sub, ids[:64].astype(np.int64)), ref["oracle_d"])
    log(f"[{tag}] oracle (64 queries): recall@100={rec} dist={res.status} "
        f"max|Δ|={res.max_abs_diff}")
    assert rec == 1.0 and res.ok, (rec, res)
    full = compare_distances(
        recompute_result_distances(ds, qs, ids.astype(np.int64)),
        recompute_result_distances(ds, qs, batched_ids.astype(np.int64)))
    log(f"[{tag}] vs the batched K1 engine on the bf16 plane, all {qs.m} queries: "
        f"{full.status} max|Δ|={full.max_abs_diff} beyond={full.num_exceeding}")
    assert full.ok, full
    del eng
    torch.cuda.empty_cache()
    return dict(qps=qs.m / wall, launches=launches, bodies=bodies, lane_bodies=lane_bodies,
                window=win, max_abs_err=win["max_abs_err"], reruns=reruns,
                upload_gb_s=rate, phases=ph, ids=ids)


# Phase 9: experiments/ivf_scale.py's own settings.
IVF_ROWS, IVF_QUERIES, IVF_CLUSTERS, IVF_CATEGORIES = 10_000_000, 4096, 1000, 1000


def path_ivf() -> dict:
    """Phase 9: the IVF engine at ``experiments/ivf_scale.py``'s settings:
    10⁷ clustered rows, 4096 type-0 queries from the same centres, cap
    1024, query_batch 1024, the engine's defaults otherwise (nprobe 16).
    The index is built on the card (k-means included); recall@100 on 64
    oracle queries must be ≥ 0.99. The engine reaches no scan kernel."""
    tag = "D=1e+07 clustered ivf"
    t0 = time.perf_counter()
    ds = generate_dataset(IVF_ROWS, seed=0, categories=IVF_CATEGORIES, clusters=IVF_CLUSTERS)
    qs = generate_queries(IVF_QUERIES, seed=1, categories=IVF_CATEGORIES,
                          clusters=IVF_CLUSTERS, centers_seed=0, types=(0,))
    log(f"[{tag}] data {time.perf_counter() - t0:.1f} s")
    reset_counts()
    t0 = time.perf_counter()
    eng = get_engine("ivf")(ds, device=DEV, cap=1024, query_batch=1024)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    idx = eng.index
    log(f"[{tag}] index built on the card in {build_s:.1f} s: buckets={idx.num_buckets} "
        f"n_pad={idx.n_pad} cap={idx.cap} nprobe={eng.nprobe} B={eng.query_batch}")
    t0 = time.perf_counter()
    sub = QuerySet(qtype=qs.qtype[:64], v=qs.v[:64], l=qs.l[:64], r=qs.r[:64], V=qs.V[:64])
    oids, odists = search_oracle_batched(ds, sub)
    log(f"[{tag}] oracle, 64 queries: {time.perf_counter() - t0:.1f} s")
    eng.search(qs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, dists = eng.search(qs)
    wall = time.perf_counter() - t0
    route = dict(eng.last_route)
    launches = dict(kernels.launches)
    rec = recall_at_k(ids[:64], oids, dists[:64], odists)
    true_d = recompute_result_distances(ds, qs, ids.astype(np.int64))
    log(f"[{tag}] search {qs.m} queries: {wall:.3f} s = {qs.m / wall:.1f} QPS; "
        f"route {route}; recall@100 (64 oracle queries) = {rec}; launches {launches}")
    assert rec >= 0.99, rec
    assert np.abs(dists - true_d).max() <= 0.002 and (np.diff(dists, axis=1) >= -1e-6).all()
    assert launches == want_level2_launches(), launches
    phases = PhaseTimer(device=DEV)
    eng.search(qs, phases=phases)
    log(f"[{tag}] phases (fenced run): {json.dumps(phases.as_dict())}")
    del eng, idx
    torch.cuda.empty_cache()
    return dict(qps=qs.m / wall, build_s=build_s, recall=rec, route=route)


# Phases 9a–9c: the mesh engines on virtual shards of the one card.
MESH_SHARDS = 4


def virtual_mesh(n_d: int, n_q: int = 1):
    """A (n_q, n_d) mesh of virtual shards, every one on this card."""
    return make_mesh(n_d, n_q, devices=[DEV] * (n_d * n_q))


def peak_gb(tag: str) -> None:
    """Log the peak of allocated card memory since the last reset (the
    build and the kernel checks, or the search), then reset it."""
    log(f"[{tag}] torch.cuda.max_memory_allocated: "
        f"{torch.cuda.max_memory_allocated(DEV) / 1e9:.3f} GB")
    torch.cuda.reset_peak_memory_stats(DEV)


def shard_kernel_vs_plain(tag, eng, qs) -> dict:
    """The mesh engine's kernel (K1, or K3 for ``scan_impl="pallas"``) at
    one shard's shape: shard 1's slab (a view at an offset into the one
    upload) at the q row's batch, against its plain version and, bit for
    bit, against the kernel on a contiguous copy of the slab; rerun twice
    bit for bit; then timed beside its bound, its plain version and its
    passes' product alone."""
    name = IMPL_KERNEL[eng.scan_impl]
    slab = eng.slabs[0][1]
    B, rows, R = eng.query_batch // eng.n_q, slab.Vp.shape[0], eng.bin_top
    plane = slab.Vs if name == "packed_scan_v3" else slab.Vp
    assert plane.untyped_storage().data_ptr() == eng.slabs[0][0].Vp.untyped_storage().data_ptr()
    qV, fields = first_batch(qs, B)
    args = (plane, slab.C, slab.T, slab.dn, slab.sid, qV, *fields, eng.n)
    kw = dict(db_tile=eng.db_tile, bin_top=R)
    fn = getattr(kernels, name)
    got = fn(*args, **kw)
    want = kernels.plain[name](*args, **kw)
    agree = scan_agreement(*got, *want, R, eng.db_tile // 128, (qV * qV).sum(1),
                           eng._dn_max, eng._rel_mm)
    del want
    log(f"[{tag}] {name} at the shard's shape vs plain (rows={rows}, B={B}, R={R}): {agree}")
    assert agree["ok"], agree
    copy = tuple(t.clone() for t in args[:5])
    assert same_bits(got, fn(*copy, *args[5:], **kw)), f"{name} on the slab view differs"
    del copy
    for _ in range(2):
        assert same_bits(got, fn(*args, **kw)), f"{name} shard rerun differs"
    del got
    log(f"[{tag}] {name} on the slab view = on its copy, and rerun twice: bit-identical")
    ms = event_ms(lambda: fn(*args, **kw), 3)
    plain_ms = event_ms(lambda: kernels.plain[name](*args, **kw), 3)
    W = rows * R // 128
    if name == "packed_scan_v3":
        bnd, passes = k1_bound(plane, B, W, rows), 3
    else:
        bnd, passes = lane_bound(name, rows, B, W), LANE_PASSES[name]
    bnd["product_only_matmul_ms"] = product_only_ms(plane, qV, 0, rows, passes)
    log(f"[{tag}] {name} shard {ms:.3f} ms/call, plain {plain_ms:.3f} ms/call, {bnd}")
    return dict(ms=ms, plain_ms=plain_ms, **bnd, max_abs_err=agree["max_abs_err"],
                rows=rows, B=B, R=R)


def run_mesh_search(tag, eng, ds, qs, ref, partner_d, kernel: str, seed: int) -> dict:
    """A mesh engine's timed search after a warm-up, with the launch counts
    set to 0 just before and read just after (``kernel`` = shards × (batches
    + rung-1 runs), every launch on the tensor-core body, nothing else); a
    fenced phase run; recall and ``.dist`` on the 64 oracle queries; every
    query within 0.002 of ``partner_d`` (a different code path's recomputed
    distances)."""
    eng.search(generate_queries(eng.query_batch, seed=seed + 2,
                                categories=workload.CATEGORIES))
    torch.cuda.synchronize()
    peak_gb(tag)
    reset_counts()
    t0 = time.perf_counter()
    ids, dists = eng.search(qs)
    wall = time.perf_counter() - t0
    search_peak = torch.cuda.max_memory_allocated(DEV) / 1e9
    launches = dict(kernels.launches)
    bodies = dict(kernels.k1_body_launches)
    lane_bodies = {k: dict(v) for k, v in kernels.lane_body_launches.items()}
    ladder = dict(eng.last_ladder)
    log(f"[{tag}] search {qs.m} queries: {wall:.3f} s = {qs.m / wall:.1f} QPS; "
        f"launches {launches}; K1 bodies {bodies}; K3 bodies {lane_bodies['packed_scan']}; "
        f"ladder {ladder}; the search's peak of card memory {search_peak:.3f} GB")
    shards = eng.n_q * eng.n_d
    want = want_level2_launches()
    want[kernel] = shards * (-(-qs.m // eng.query_batch) + ladder.get("rung1_runs", 0))
    assert launches == want, (launches, want)
    got_bodies = bodies if kernel == "packed_scan_v3" else lane_bodies[kernel]
    assert got_bodies == {"wgmma": want[kernel], "simt": 0}, got_bodies
    if ladder["suspects"]:
        assert ladder["rung1_bin_top"] == 2 * eng.bin_top, ladder
    assert ids.shape == (qs.m, 100) and np.isfinite(dists).all() and (ids < ds.n).all()
    phases = PhaseTimer(device=DEV)
    eng.search(qs, phases=phases)
    log(f"[{tag}] phases (fenced run): {json.dumps(phases.as_dict())}")
    sub = ref["sub"]
    rec = recall_at_k(ids[:64], ref["oids"], dists[:64], ref["odists"])
    res = compare_distances(
        recompute_result_distances(ds, sub, ids[:64].astype(np.int64)), ref["oracle_d"])
    log(f"[{tag}] oracle (64 queries): recall@100={rec} dist={res.status} "
        f"max|Δ|={res.max_abs_diff}")
    assert rec == 1.0 and res.ok, (rec, res)
    full = compare_distances(recompute_result_distances(ds, qs, ids.astype(np.int64)),
                             partner_d)
    log(f"[{tag}] vs its partner path, all {qs.m} queries: {full.status} "
        f"max|Δ|={full.max_abs_diff} beyond={full.num_exceeding}")
    assert full.ok, full
    return dict(qps=qs.m / wall, launches=launches, bodies=bodies, lane_bodies=lane_bodies,
                ladder=ladder, phases=phases.as_dict(), search_peak_gb=search_peak, ids=ids)


def build_mesh_engine(tag, name, ds, mesh, **kw):
    """The engine ``name`` on ``mesh``, with the card memory it holds after
    its build: one database however many virtual shards share the card."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(DEV)
    t0 = time.perf_counter()
    eng = get_engine(name)(ds, mesh=mesh, **kw)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(DEV) - before
    log(f"[{tag}] {name} on a {mesh.shape} mesh of {mesh.distinct()} built in "
        f"{time.perf_counter() - t0:.1f} s; it holds {held / 1e9:.3f} GB of card memory")
    return eng, held


def path_sharded(ds, qs, ref, batched_ids) -> dict:
    """Phase 9a: ``sharded`` on phase 6's 10⁷ rows and 10⁴ queries: K1 per
    shard on the fp32 plane, B 1024, 4 virtual shards of the card (n_pad
    10,027,008, 2,506,752 rows = 153 tiles a shard), then the same engine
    on a 1-shard mesh. Partner: phase 6's batched K1 answer (bf16 plane)."""
    tag = f"D=1e+07 fp32 sharded {MESH_SHARDS}"
    partner_d = recompute_result_distances(ds, qs, batched_ids.astype(np.int64))
    eng, held = build_mesh_engine(tag, "sharded", ds, virtual_mesh(MESH_SHARDS),
                                  query_batch=1024)
    log(f"[{tag}] engine: n_pad={eng.n_pad} local_n={eng.local_n} "
        f"tiles/shard={eng.local_n // eng.db_tile} db_tile={eng.db_tile} R={eng.bin_top} "
        f"k'={eng.kprime} B={eng.query_batch} scan_impl={eng.scan_impl}")
    assert eng.scan_impl == "v3" and eng.certified and eng.n_pad % (MESH_SHARDS * 16384) == 0
    db_bytes = eng.n_pad * 128 * 4
    # one copy of the database (≈ 5.13 GB at 10⁷ rows) and its columns, not four
    assert db_bytes <= held < 1.2 * db_bytes, (held, db_bytes)
    shard = shard_kernel_vs_plain(tag, eng, qs)
    r = run_mesh_search(tag, eng, ds, qs, ref, partner_d, "packed_scan_v3", seed=300)
    r.update(shard=shard, held_gb=held / 1e9, max_abs_err=shard["max_abs_err"])
    peak_gb(tag)
    del eng
    torch.cuda.empty_cache()
    tag1 = "D=1e+07 fp32 sharded 1"
    eng, held1 = build_mesh_engine(tag1, "sharded", ds, virtual_mesh(1), query_batch=1024)
    log(f"[{tag1}] engine: n_pad={eng.n_pad} R={eng.bin_top}")
    r1 = run_mesh_search(tag1, eng, ds, qs, ref, partner_d, "packed_scan_v3", seed=300)
    r1.pop("ids")
    r["one_shard"] = dict(r1, held_gb=held1 / 1e9)
    log(f"[{tag}] the mesh on one card: {r['qps']:.1f} QPS on {MESH_SHARDS} virtual "
        f"shards, {r1['qps']:.1f} on 1")
    peak_gb(tag1)
    del eng
    torch.cuda.empty_cache()
    return r


def path_sharded_k3(ds, qs, ref) -> dict:
    """Phase 9b: ``sharded`` with ``scan_impl="pallas"`` (K3 per shard,
    8192-row tiles) on phase 4's 10⁶ rows and 10⁴ queries, on a 2×2 (q, d)
    mesh of the card. Partner: phase 4's streaming answer."""
    tag = "D=1e+06 fp32 sharded K3 2x2"
    eng, held = build_mesh_engine(tag, "sharded", ds, virtual_mesh(2, 2), query_batch=1024,
                                  scan_impl="pallas")
    log(f"[{tag}] engine: n_pad={eng.n_pad} local_n={eng.local_n} "
        f"tiles/shard={eng.local_n // eng.db_tile} db_tile={eng.db_tile} R={eng.bin_top} "
        f"k'={eng.kprime} B={eng.query_batch} scan_impl={eng.scan_impl}")
    assert eng.scan_impl == "v1" and eng.db_tile == 8192 and eng.bin_top <= 4
    assert eng.n_pad * 512 <= held < 1.2 * eng.n_pad * 512, held
    shard = shard_kernel_vs_plain(tag, eng, qs)
    r = run_mesh_search(tag, eng, ds, qs, ref, ref["stream_d"], "packed_scan", seed=100)
    r.pop("ids")
    r.update(shard=shard, held_gb=held / 1e9, max_abs_err=shard["max_abs_err"])
    peak_gb(tag)
    del eng
    torch.cuda.empty_cache()
    return r


def path_partitioned_sharded(ds, qs6, ref, partitioned_ids,
                             seed: int = workload.PARTITIONED_SEED) -> dict:
    """Phase 9c: ``partitioned_sharded`` on phase 6's rows, the bf16 plane
    and phase 7's 4·10⁴ queries, on 4 virtual shards of the card. Partner:
    phase 7's partitioned answer."""
    tag = f"D=1e+07 bf16 partitioned_sharded {MESH_SHARDS}"
    qs = workload.partitioned_queries(qs6, seed)
    partner_d = recompute_result_distances(ds, qs, partitioned_ids.astype(np.int64))
    eng, held = build_mesh_engine(tag, "partitioned_sharded", ds, virtual_mesh(MESH_SHARDS),
                                  scan_store="bf16")
    cv = eng.index.cat_view
    log(f"[{tag}] engine: index {eng.index.build_seconds}; n_pad={cv.n_pad} "
        f"local_n={eng._local_n} R={eng.bin_top} k'={eng.kprime} B={eng.query_batch} "
        f"caps={eng.route_buckets} scan_impl={eng.scan_impl}")
    assert eng.scan_impl == "v3" and eng.certified and eng.kprime == 240
    assert held < 1.2 * cv.nbytes, (held, cv.nbytes)
    t0 = time.perf_counter()
    eng.search(qs)
    torch.cuda.synchronize()
    log(f"[{tag}] warm-up search {time.perf_counter() - t0:.1f} s (time view built in "
        f"{eng.index.build_seconds.get('time_view', float('nan')):.1f} s); "
        f"route {json.dumps(eng.last_route)}")
    views = [eng.index.cat_view, eng.index.time_view]
    planes = [v.scan_V for mv in views for v in mv.shards]
    assert len({p.untyped_storage().data_ptr() for p in planes}) == len(views)
    peak_gb(tag)
    reset_counts()
    t0 = time.perf_counter()
    ids, dists = eng.search(qs)
    wall = time.perf_counter() - t0
    search_peak = torch.cuda.max_memory_allocated(DEV) / 1e9
    launches, route = dict(kernels.launches), dict(eng.last_route)
    bodies = dict(kernels.k1_body_launches)
    lane_bodies = {k: dict(v) for k, v in kernels.lane_body_launches.items()}
    log(f"[{tag}] search {qs.m} queries: {wall:.3f} s = {qs.m / wall:.1f} QPS; "
        f"launches {launches}; K1 bodies {bodies}; route {json.dumps(route)}; "
        f"the search's peak of card memory {search_peak:.3f} GB")
    want = want_level2_launches()
    want["packed_scan_v3"] = MESH_SHARDS * (route["full_batches"]
                                            + sum(route["windowed_batches"].values())
                                            + route["ladder"].get("rung1_runs", 0))
    assert launches == want, (launches, want)
    assert bodies == {"wgmma": want["packed_scan_v3"], "simt": 0}, bodies
    assert route["windowed"] > 0 and route["routed_time"] == 0, route
    assert sum(route["routed_groups"].values()) >= 1, route
    assert ids.shape == (qs.m, 100) and np.isfinite(dists).all() and (ids < ds.n).all()
    phases = PhaseTimer(device=DEV)
    eng.search(qs, phases=phases)
    log(f"[{tag}] phases (fenced run): {json.dumps(phases.as_dict())}")
    sub = ref["sub"]
    rec = recall_at_k(ids[:64], ref["oids"], dists[:64], ref["odists"])
    res = compare_distances(
        recompute_result_distances(ds, sub, ids[:64].astype(np.int64)), ref["oracle_d"])
    log(f"[{tag}] oracle (64 queries): recall@100={rec} dist={res.status} "
        f"max|Δ|={res.max_abs_diff}")
    assert rec == 1.0 and res.ok, (rec, res)
    full = compare_distances(recompute_result_distances(ds, qs, ids.astype(np.int64)),
                             partner_d)
    log(f"[{tag}] vs the partitioned engine (phase 7), all {qs.m} queries: {full.status} "
        f"max|Δ|={full.max_abs_diff} beyond={full.num_exceeding}")
    assert full.ok, full
    peak_gb(tag)
    del eng
    torch.cuda.empty_cache()
    return dict(qps=qs.m / wall, launches=launches, bodies=bodies, lane_bodies=lane_bodies,
                route=route, phases=phases.as_dict(), held_gb=held / 1e9,
                search_peak_gb=search_peak, ids=ids)


# Phase 10: the options this port slice adds, on the card.
REPAIR_BINS = 2


def oracle_and_partner(tag, ds, qs, ids, dists, ref, partner_ids, what: str) -> dict:
    """Recall 1.0 and ``.dist`` "same" or "similar" (≤ 0.002, as every
    earlier phase holds it: the paged engine's host finalize breaks
    near-ties its own way) on the 64 oracle queries, and every query
    within 0.002 of ``partner_ids`` (another path's answer)."""
    sub = ref["sub"]
    rec = recall_at_k(ids[:64], ref["oids"], dists[:64], ref["odists"])
    res = compare_distances(
        recompute_result_distances(ds, sub, ids[:64].astype(np.int64)), ref["oracle_d"])
    log(f"[{tag}] oracle (64 queries): recall@100={rec} dist={res.status} "
        f"max|Δ|={res.max_abs_diff}")
    assert rec == 1.0 and res.ok, (rec, res)
    full = compare_distances(recompute_result_distances(ds, qs, ids.astype(np.int64)),
                             recompute_result_distances(ds, qs, partner_ids.astype(np.int64)))
    log(f"[{tag}] vs {what}, all {qs.m} queries: {full.status} "
        f"max|Δ|={full.max_abs_diff} beyond={full.num_exceeding}")
    assert full.ok, full
    return dict(recall=rec, dist=res.status, partner=full.status,
                partner_max_abs_diff=full.max_abs_diff)


def repaired_search(tag, eng, ds, qs, ref, partner_ids, base: dict, k1_want, ladder_of,
                    warm) -> dict:
    """One engine built with ``repair_bins=2`` (and forensics): a warm-up
    (``warm``), the timed search with the launch counts set to 0 just
    before it (K1 = ``k1_want(eng, ladder)``, every launch on the
    tensor-core body, nothing else), its ladder beside ``base`` (the same
    engine's without repair, an earlier phase's), the certificate's term
    histogram, a fenced phase run (the repair's own ``*/repair`` phase),
    and the oracle and partner checks."""
    eng.search(warm)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ids, dists = eng.search(qs)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    bodies = dict(kernels.k1_body_launches)
    ladder = ladder_of(eng)
    terms = getattr(eng, "_last_cert_terms", None)
    hist = None if terms is None else {int(t): int(c) for t, c in
                                       zip(*np.unique(terms, return_counts=True))}
    log(f"[{tag}] search {qs.m} queries: {wall:.3f} s = {qs.m / wall:.1f} QPS; launches "
        f"{launches}; K1 bodies {bodies}; ladder with repair_bins={REPAIR_BINS} "
        f"{json.dumps(ladder)} vs without {json.dumps(base)}; certificate terms "
        f"(1 bin, 2 level 2, 4 k'-cut) {hist}")
    want = want_level2_launches()
    want["packed_scan_v3"] = k1_want(eng, ladder)
    assert launches == want, (launches, want)
    assert bodies == {"wgmma": want["packed_scan_v3"], "simt": 0}, bodies
    assert ids.shape == (qs.m, 100) and np.isfinite(dists).all() and (ids < ds.n).all()
    # no id twice (the repair's dedup) where no tail pad can repeat one
    assert all(len(set(row)) == 100 for row in ids[qs.qtype == 0].tolist())
    phases = PhaseTimer(device=DEV)
    eng.search(qs, phases=phases)
    ph = phases.as_dict()
    repair = {k: v for k, v in ph.items() if k.endswith("/repair")}
    assert repair, ph
    log(f"[{tag}] phases (fenced run): {json.dumps(ph)}; the repair's own: {repair}")
    checks = oracle_and_partner(tag, ds, qs, ids, dists, ref, partner_ids,
                                "the same engine without repair")
    return dict(qps=qs.m / wall, launches=launches, bodies=bodies, ladder=ladder,
                base_ladder=base, terms=hist, repair_phase=repair, phases=ph, **checks)


def path_repair(ds, qs6, ref, db6, index7, answers: dict, bases: dict) -> dict:
    """Phase 10a: ``repair_bins=2`` on the card: the batched K1 engine on
    phase 6's database (bf16 plane), the partitioned engine on phase 7's
    index and queries (then again with ``repair_gate=True``), the paged
    engine (phase 8's windows), ``sharded`` on 4 virtual shards (9a) and
    ``partitioned_sharded`` (9c); each held to its phase's unrepaired
    answer (``answers``) with its ladder beside that phase's (``bases``)."""
    qs7 = workload.partitioned_queries(qs6)
    warm = generate_queries(1024, seed=302, categories=workload.CATEGORIES)
    out = {}
    os.environ["HVQ_CERT_TERMS"] = "1"      # forensics, read at construction
    try:
        ladder = lambda e: dict(e.last_ladder)
        route_ladder = lambda e: dict(e.last_route["ladder"], flagged=e.last_route["suspects"],
                                      dense_straddling=e.last_route["dense_straddling"])
        eng = get_engine("batched")(ds, device=DEV, device_db=db6, repair_bins=REPAIR_BINS)
        assert eng.scan_impl == "v3" and eng.certified and eng._bf16_scan
        out["batched"] = repaired_search(
            "D=1e+07 bf16 batched repaired", eng, ds, qs6, ref, answers["batched"],
            bases["batched"], lambda e, lad: -(-qs6.m // e.query_batch)
            + lad.get("rung1_runs", 0), ladder, warm)
        del eng
        for gate in (False, True):
            name = "partitioned_gated" if gate else "partitioned"
            eng = get_engine("partitioned")(ds, device=DEV, index=index7,
                                            repair_bins=REPAIR_BINS, repair_gate=gate)
            out[name] = repaired_search(
                f"D=1e+07 bf16 partitioned repaired{' gated' if gate else ''}", eng, ds,
                qs7, ref, answers["partitioned"], bases["partitioned"],
                lambda e, lad: (e.last_route["full_batches"]
                                + sum(e.last_route["windowed_batches"].values())
                                + lad.get("rung1_runs", 0)), route_ladder, warm)
            del eng
        torch.cuda.empty_cache()
        eng = get_engine("paged")(ds, device=DEV, window_rows=PAGED_WINDOW_ROWS,
                                  scan_impl="v3", repair_bins=REPAIR_BINS)
        out["paged"] = repaired_search(
            "D=1e+07 fp32 paged repaired", eng, ds, qs6, ref, answers["paged"],
            bases["paged"], lambda e, lad: len(e.windows) * -(-qs6.m // e.query_batch),
            lambda e: dict(e.last_reruns), warm)
        del eng
        torch.cuda.empty_cache()
        eng, _ = build_mesh_engine("D=1e+07 fp32 sharded repaired", "sharded", ds,
                                   virtual_mesh(MESH_SHARDS), query_batch=1024,
                                   repair_bins=REPAIR_BINS)
        out["sharded"] = repaired_search(
            f"D=1e+07 fp32 sharded {MESH_SHARDS} repaired", eng, ds, qs6, ref,
            answers["sharded"], bases["sharded"],
            lambda e, lad: MESH_SHARDS * (-(-qs6.m // e.query_batch)
                                          + lad.get("rung1_runs", 0)), ladder, warm)
        del eng
        torch.cuda.empty_cache()
        eng, _ = build_mesh_engine("D=1e+07 bf16 partitioned_sharded repaired",
                                   "partitioned_sharded", ds, virtual_mesh(MESH_SHARDS),
                                   scan_store="bf16", repair_bins=REPAIR_BINS)
        out["partitioned_sharded"] = repaired_search(
            f"D=1e+07 bf16 partitioned_sharded {MESH_SHARDS} repaired", eng, ds, qs7, ref,
            answers["partitioned_sharded"], bases["partitioned_sharded"],
            lambda e, lad: MESH_SHARDS * (e.last_route["full_batches"]
                                          + sum(e.last_route["windowed_batches"].values())
                                          + lad.get("rung1_runs", 0)), route_ladder, qs7)
        del eng
        torch.cuda.empty_cache()
    finally:
        os.environ.pop("HVQ_CERT_TERMS", None)
    return out


def path_deferred(ds, qs, ref, lane_db) -> dict:
    """Phase 10b: the batched engine with ``scan_impl="xla_deferred"`` (the
    unpacked deferred bin scan, no kernel; lane bins on phase 4's
    8192-row fp32 database) at D=10⁶, held to phase 4's streaming answer;
    its ladder's rung 1 is K1 (axis1), counted."""
    tag = "D=1e+06 fp32 xla_deferred"
    eng = get_engine("batched")(ds, device=DEV, device_db=lane_db, scan_impl="xla_deferred")
    log(f"[{tag}] engine: db_tile={eng.db.db_tile} R={eng.bin_top} k'={eng.kprime} "
        f"scan_impl={eng.scan_impl} certified={eng.certified}")
    assert eng.scan_impl == "deferred" and eng.certified
    eng.search(generate_queries(eng.query_batch, seed=102, categories=workload.CATEGORIES))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ids, dists = eng.search(qs)
    wall = time.perf_counter() - t0
    launches, ladder = dict(kernels.launches), dict(eng.last_ladder)
    bodies = dict(kernels.k1_body_launches)
    log(f"[{tag}] search {qs.m} queries: {wall:.3f} s = {qs.m / wall:.1f} QPS; "
        f"launches {launches}; K1 bodies {bodies}; ladder {ladder}")
    want = want_level2_launches()
    want["packed_scan_v3"] = ladder.get("rung1_runs", 0)
    assert launches == want, (launches, want)
    assert bodies == {"wgmma": want["packed_scan_v3"], "simt": 0}, bodies
    phases = PhaseTimer(device=DEV)
    eng.search(qs, phases=phases)
    log(f"[{tag}] phases (fenced run): {json.dumps(phases.as_dict())}")
    sub = ref["sub"]
    rec = recall_at_k(ids[:64], ref["oids"], dists[:64], ref["odists"])
    res = compare_distances(
        recompute_result_distances(ds, sub, ids[:64].astype(np.int64)), ref["oracle_d"])
    full = compare_distances(recompute_result_distances(ds, qs, ids.astype(np.int64)),
                             ref["stream_d"])
    log(f"[{tag}] oracle (64 queries): recall@100={rec} dist={res.status}; vs phase 4's "
        f"stream path, all {qs.m} queries: {full.status} max|Δ|={full.max_abs_diff} "
        f"beyond={full.num_exceeding}")
    assert rec == 1.0 and res.ok and full.ok, (rec, res, full)
    return dict(qps=qs.m / wall, launches=launches, bodies=bodies, ladder=ladder)


def path_strategies(ds, qs, ref, lane_db) -> dict:
    """Phase 10c: the streaming scan (``scan_impl="xla"``) with
    ``topk_strategy`` ``"sort"`` (exact: within 0.002 of phase 4's
    streaming answer) and ``"binned"`` (approximate: its recall against
    that answer, ≥ 0.95) on the first 1024 of phase 4's queries."""
    sub = QuerySet(qtype=qs.qtype[:1024], v=qs.v[:1024], l=qs.l[:1024], r=qs.r[:1024],
                   V=qs.V[:1024])
    stream_d = ref["stream_d"][:1024]
    out = {}
    for strategy in ("sort", "binned"):
        tag = f"D=1e+06 fp32 stream {strategy}"
        eng = get_engine("batched")(ds, device=DEV, device_db=lane_db, scan_impl="xla",
                                    topk_strategy=strategy)
        eng.search(generate_queries(64, seed=103, categories=workload.CATEGORIES))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        ids, dists = eng.search(sub)
        wall = time.perf_counter() - t0
        assert kernels.launches == want_level2_launches(), kernels.launches
        assert np.isfinite(dists).all() and (ids < ds.n).all()
        got_d = recompute_result_distances(ds, sub, ids.astype(np.int64))
        full = compare_distances(got_d, stream_d)
        # recall against the exact answer: its distances as the ids' stand-in
        rec = float(np.mean([np.isin(a, b).mean() for a, b in zip(got_d, stream_d)]))
        log(f"[{tag}] search {sub.m} queries: {wall:.3f} s = {sub.m / wall:.1f} QPS; vs "
            f"phase 4's stream answer: {full.status} max|Δ|={full.max_abs_diff} "
            f"beyond={full.num_exceeding}; recall@100 {rec:.5f}")
        if strategy == "sort":
            assert full.ok, full
        else:
            assert rec >= 0.95, rec
        out[strategy] = dict(qps=sub.m / wall, status=full.status, recall=rec)
        del eng
    return out


def path_bf16_storage(ds, qs, ref) -> dict:
    """Phase 10d: ``dtype=bfloat16`` (the uncertified bf16 storage; K1 reads
    it as its bf16 plane) at D=10⁶: recall with a 50.0 distance tolerance
    ≥ 0.95 on the 64 oracle queries and the relative distance error of
    every reported id < 0.05 (``tests/test_engines.py:150-172``)."""
    tag = "D=1e+06 bf16 storage"
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(DEV)
    eng = get_engine("batched")(ds, device=DEV, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(DEV) - before
    log(f"[{tag}] engine: Vp {eng.db.Vp.dtype} n_pad={eng.db.n_pad} R={eng.bin_top} "
        f"scan_impl={eng.scan_impl} certified={eng.certified}; holds {held / 1e9:.3f} GB")
    assert eng.db.Vp.dtype == torch.bfloat16 and not eng.certified
    eng.search(generate_queries(eng.query_batch, seed=104, categories=workload.CATEGORIES))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ids, dists = eng.search(qs)
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    want = want_level2_launches()
    if eng.scan_impl == "v3":
        want["packed_scan_v3"] = -(-qs.m // eng.query_batch)
    assert launches == want, (launches, want)
    rec = recall_at_k(ids[:64], ref["oids"], dists[:64], ref["odists"], tolerance=50.0)
    true_d = recompute_result_distances(ds, qs, ids.astype(np.int64))
    rel = float((np.abs(dists - true_d) / np.maximum(true_d, 1.0)).max())
    log(f"[{tag}] search {qs.m} queries: {wall:.3f} s = {qs.m / wall:.1f} QPS; launches "
        f"{launches}; recall@100 (tolerance 50, 64 oracle queries) = {rec}; max relative "
        f"distance error {rel:.6f}")
    assert rec >= 0.95 and rel < 0.05, (rec, rel)
    del eng
    torch.cuda.empty_cache()
    return dict(qps=qs.m / wall, launches=launches, recall_tol50=rec, max_rel_err=rel,
                held_gb=held / 1e9)


NATIVE_ROWS, NATIVE_QUERIES = 1_000_000, 1000


def path_native_cli() -> dict:
    """Phase 10e: the port's CLI on a D=10⁶ file pair: gen-data and
    gen-queries, the native library (its file name), the native mmap read
    against the NumPy memmap read bit for bit, ``run`` (batched, the card)
    with its host counters, and the counters the host allowed."""
    import contextlib
    import io

    from hvq_tpu_torch import native
    from hvq_tpu_torch.cli.main import main as cli

    tag = "native + CLI D=1e+06"
    out = {}
    with tempfile.TemporaryDirectory() as d:
        data, query = os.path.join(d, "data.bin"), os.path.join(d, "query.bin")
        t0 = time.perf_counter()
        assert cli(["gen-data", data, str(NATIVE_ROWS), "--categories", "100"]) == 0
        assert cli(["gen-queries", query, str(NATIVE_QUERIES), "--categories", "100"]) == 0
        log(f"[{tag}] gen-data + gen-queries {time.perf_counter() - t0:.1f} s")
        assert native.available()
        lib = os.path.basename(native.build_info["path"])
        assert lib.startswith("libhvq_native_")
        t0 = time.perf_counter()
        rec = native.read_records(data, 102)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        mm = np.array(np.memmap(data, dtype=np.float32, mode="r", offset=4)).reshape(-1, 102)
        t_numpy = time.perf_counter() - t0
        same = rec.shape == mm.shape and np.array_equal(rec.view(np.int32), mm.view(np.int32))
        log(f"[{tag}] native library {lib}; read {rec.shape}: native {t_native:.3f} s, "
            f"numpy memmap {t_numpy:.3f} s, bit-identical {same}")
        assert same
        del rec, mm
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli(["run", "--data", data, "--queries", query, "--engine", "batched",
                      "--device", DEV.type, "--output", os.path.join(d, "out.bin")])
        out["run_s"] = time.perf_counter() - t0
        assert rc == 0, err.getvalue()
        lines = err.getvalue().splitlines()
        # the counter table (an aligned header row "wall_s ..." and its
        # values), or the line saying the host allowed no counter
        idx = next((i for i, ln in enumerate(lines) if ln.split()[:1] == ["wall_s"]), None)
        table = (lines[idx : idx + 2] if idx is not None
                 else [ln for ln in lines if ln.startswith("host counters:")])
        log(f"[{tag}] run --engine batched: {out['run_s']:.1f} s; its counters "
            f"{table}; {[ln for ln in lines if ' QPS' in ln]}")
        assert len(table) in (1, 2), lines
    with native.PerfCounters() as pc:
        np.dot(np.ones((512, 512)), np.ones((512, 512)))
    pc.close()
    log(f"[{tag}] counters the host allowed: {sorted(pc.values)} of "
        f"{list(native.PERF_COUNTER_NAMES)}; report {pc.report()}")
    assert set(pc.values) <= set(native.PERF_COUNTER_NAMES)
    return dict(library=lib, read_native_s=t_native, read_numpy_s=t_numpy,
                counters=sorted(pc.values), cli_table=table, **out)


HARNESS_ROWS, HARNESS_QUERIES = 100_000, 1000


def path_harness() -> dict:
    """Phase 11: the CLI in process on the card: gen-data 10⁵ and
    gen-queries 10³ (100 categories), build-index of both kinds, ``run`` of
    every ported engine but the oracle (paged resilient with 16384-row
    windows, partitioned and ivf from their checkpoints, the mesh engines
    on the default mesh of every visible card, batched once more under
    ``--profile``), and ``compare`` of the exact engines."""
    from hvq_tpu_torch.cli.main import main as cli

    tag = "harness"
    dev = DEV.type
    out = {}
    with tempfile.TemporaryDirectory() as d:
        data, query = os.path.join(d, "data.bin"), os.path.join(d, "query.bin")
        assert cli(["gen-data", data, str(HARNESS_ROWS), "--categories", "100"]) == 0
        assert cli(["gen-queries", query, str(HARNESS_QUERIES), "--categories", "100"]) == 0
        for kind in ("partitioned", "ivf"):
            t0 = time.perf_counter()
            assert cli(["build-index", "--data", data, "--kind", kind,
                        "--out", os.path.join(d, f"{kind}.npz"), "--device", dev]) == 0
            log(f"[{tag}] build-index --kind {kind}: {time.perf_counter() - t0:.1f} s")
        runs = {
            "batched": [],
            "partitioned": ["--index", os.path.join(d, "partitioned.npz")],
            "paged": ["--resilient", "--engine-opt", "window_rows=16384"],
            "ivf": ["--index", os.path.join(d, "ivf.npz")],
            # the mesh engines on the default mesh: every visible card
            "sharded": [],
            "partitioned_sharded": [],
            "profiled": ["--profile", os.path.join(d, "trace")],
        }
        reset_counts()
        for name, extra in runs.items():
            engine = "batched" if name == "profiled" else name
            t0 = time.perf_counter()
            assert cli(["run", "--data", data, "--queries", query, "--engine", engine,
                        "--device", dev, "--output", os.path.join(d, f"{name}.bin"),
                        *extra]) == 0
            out[name] = time.perf_counter() - t0
            log(f"[{tag}] run --engine {engine} {' '.join(extra)}: {out[name]:.1f} s")
        launches = dict(kernels.launches)
        log(f"[{tag}] launches over the runs: {launches}")
        assert launches["packed_scan_v3"] >= 3, launches
        trace = os.path.join(d, "trace", "trace.json")
        assert os.path.getsize(trace) > 0
        rc = cli(["compare", *(os.path.join(d, f"{e}.bin")
                               for e in ("batched", "partitioned", "paged", "sharded",
                                         "partitioned_sharded"))])
        assert rc == 0, rc
    return dict(run_s=out, launches=launches)


BENCH_ROWS, BENCH_QUERIES = 1_000_000, 10_000       # phase 12c's runner
LATENCY_ROWS, LATENCY_CALLS = 1_000_000, 50          # phase 12d's


def counted() -> dict:
    """The launch counts since the last reset, in a path result's keys."""
    return dict(launches=dict(kernels.launches), bodies=dict(kernels.k1_body_launches),
                lane_bodies={k: dict(v) for k, v in kernels.lane_body_launches.items()},
                level2_bodies=dict(kernels.level2_body_launches))


def runner_counts(rec: dict) -> dict:
    """A runner line's launches (its median timed search) in a path
    result's keys."""
    by_body = rec["launches_by_body"]
    return dict(launches=rec["launches"], bodies=by_body["packed_scan_v3"],
                lane_bodies={k: by_body[k] for k in kernels.lane_body_launches},
                level2_bodies=by_body["level2_select"])


def assert_k1_only(tag: str, counts: dict, wgmma: int | None = None) -> None:
    """The path launched K1 (and the level-2 select) and no lane kernel;
    every K1 launch on its tensor-core body, or (``wgmma`` given) at least
    that many of them."""
    k1 = counts["launches"]["packed_scan_v3"]
    bodies = counts["bodies"]
    assert k1 >= 1 and bodies["wgmma"] + bodies["simt"] == k1, (tag, counts)
    assert bodies["wgmma"] >= (k1 if wgmma is None else wgmma), (tag, counts)
    assert all(v == 0 for k, v in counts["launches"].items()
               if k not in ("packed_scan_v3", "level2_select")), (tag, counts)
    assert counts["level2_bodies"] == {"registers": counts["launches"]["level2_select"],
                                       "shared": 0}, (tag, counts)


def path_runner(ds, qs6) -> dict:
    """Phase 12: the harness around the engines. (a) the mesh dry run on
    4 virtual shards of the card with its capacity leg (D=10⁶: ≥ 16 tiles
    a shard, 4 paged windows, recall 1.0 both); the full-diff partners'
    card bytes a row at D=10⁶ against ``bench.PARTNER_BYTES_PER_ROW``;
    (b) the benchmark runner's measuring function in process at its
    default shape, ``partitioned`` over phase 6's 10⁷ rows (bf16 plane)
    with phase 7's 4·10⁴ queries: 3 timed runs, the 64-query oracle check
    and a full diff against ``batched`` over every query; (c) ``python -m
    hvq_tpu_torch.tools.bench`` as a subprocess (``batched``, D=10⁶,
    Q=10⁴, no dataset cache): exit 0 and its last line; (d) the serving
    latency tool at D=10⁶, 50 calls a batch size."""
    from hvq_tpu_torch.entry import dryrun_multichip
    from hvq_tpu_torch.tools import bench, serving_latency

    out = {}
    tag = "runner"
    t0 = time.perf_counter()
    reset_counts()
    dry = dryrun_multichip(MESH_SHARDS, device=DEV.type)
    out["dryrun"] = dict(counted(), seconds=time.perf_counter() - t0, **dry)
    cap = dry["capacity"]
    log(f"[{tag}] 12a dryrun_multichip({MESH_SHARDS}) with the capacity leg: "
        f"{json.dumps(out['dryrun'])}")
    assert cap["tiles_per_shard"] >= 16 and cap["windows"] == 4, cap
    # the small legs' 128-row tiles pick R > 8 (the CUDA-core body); the
    # capacity leg's 8192-row tiles one launch a shard and a window on
    # the tensor-core body
    assert_k1_only("12a", out["dryrun"], wgmma=MESH_SHARDS + cap["windows"])

    # the partners' footprint, on the runner's own D=10⁶ data (12c's)
    ds1 = generate_dataset(BENCH_ROWS, seed=0, categories=1000)
    qs1 = generate_queries(BENCH_QUERIES, seed=1, categories=1000, centers_seed=0)
    foot = {p: bench.partner_footprint(p, ds1, qs1, DEV) for p in ("batched", "partitioned")}
    log(f"[{tag}] full-diff partners' card bytes a row at D={BENCH_ROWS:.0e}, "
        f"{BENCH_QUERIES} queries: {foot}; the runner's table "
        f"{bench.PARTNER_BYTES_PER_ROW}")
    out["partner_bytes_per_row"] = foot
    assert all(bench.PARTNER_BYTES_PER_ROW[p] >= b for p, b in foot.items()), foot
    # the batched engine's ids-only fetch against the full fetch, in turns
    eng = get_engine("batched")(ds1, device=DEV)
    eng.search(qs1, return_dists=False)
    qps = {"full": [], "ids_only": []}
    for kind in ("full", "ids_only", "ids_only", "full", "full", "ids_only"):
        t0 = time.perf_counter()
        ids, dists = eng.search(qs1, return_dists=kind == "full")
        qps[kind].append(qs1.m / (time.perf_counter() - t0))
        if kind == "full":
            ids_full = ids
        else:
            assert dists is None
    assert np.array_equal(ids, ids_full)
    out["fetch_qps_d1e6"] = qps
    log(f"[{tag}] batched D={BENCH_ROWS:.0e} fp32, {qs1.m} queries, QPS by fetch: "
        f"{json.dumps(qps)}")
    del eng, ds1, qs1
    torch.cuda.empty_cache()

    qs = workload.partitioned_queries(qs6)
    lines = []
    t0 = time.perf_counter()
    rec = bench.run(ds, qs, "partitioned", DEV, emit=lines.append)
    log(f"[{tag}] 12b the runner in process ({time.perf_counter() - t0:.1f} s), "
        f"{len(lines)} lines; the last: {json.dumps(rec)}")
    out["bench_d1e7"] = dict(runner_counts(rec), qps=rec["value"], record=rec)
    assert rec["timed_runs"] == 3 and len(rec["run_qps"]) == 3, rec
    assert rec["checked_queries"] == 64 and rec["recall_at_100"] == 1.0, rec
    assert rec["dist_check"] == "same", rec
    assert rec["full_diff"] in ("same", "similar"), rec
    assert rec["full_diff_queries"] == qs.m == 40_000, rec
    assert rec["full_diff_engines"] == ["partitioned", "batched_fp32"], rec
    assert rec["scan_impl"] == "v3" and rec["backend"] == "torch", rec
    assert_k1_only("12b", out["bench_d1e7"])
    del qs

    env = dict(os.environ, HVQ_BENCH_N=str(BENCH_ROWS), HVQ_BENCH_Q=str(BENCH_QUERIES),
               HVQ_BENCH_ENGINE="batched", HVQ_BENCH_CACHE="")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "hvq_tpu_torch.tools.bench"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                          capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"[{tag}] 12c python -m hvq_tpu_torch.tools.bench (batched, D={BENCH_ROWS:.0e}, "
        f"Q={BENCH_QUERIES}; {sub_s:.1f} s, rc 0): {json.dumps(last)}")
    out["bench_subprocess"] = dict(runner_counts(last), qps=last["value"], record=last,
                                   seconds=sub_s)
    assert last["recall_at_100"] == 1.0 and last["dist_check"] == "same", last
    assert last["full_diff"] in ("same", "similar"), last
    assert last["full_diff_engines"] == ["batched", "partitioned_fp32"], last
    assert_k1_only("12c", out["bench_subprocess"])

    saved = {k: os.environ.get(k) for k in ("SL_N", "SL_CALLS")}
    os.environ.update(SL_N=str(LATENCY_ROWS), SL_CALLS=str(LATENCY_CALLS))
    t0 = time.perf_counter()
    reset_counts()
    try:
        recs = serving_latency.main(DEV.type)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["latency"] = dict(counted(), records=recs, seconds=time.perf_counter() - t0)
    assert [(r["engine"], r["batch"]) for r in recs] == [
        ("batched", 1), ("batched", 16), ("partitioned", 1), ("partitioned", 16)], recs
    assert all(r["calls"] == LATENCY_CALLS for r in recs), recs
    assert_k1_only("12d", out["latency"])
    return out


def kernel_entries(r6: dict, r7: dict, r8: dict, worst: dict, cert: dict,
                   deterministic: dict, library: str, paged: dict | None = None,
                   mesh: dict | None = None, options: dict | None = None,
                   runner: dict | None = None) -> list:
    """The kernels line's entries of K1–K4 from the main paths' results
    (phases 4–7, phase 8's paged engine, phases 9a–9c's mesh engines,
    phase 10's repaired engines and ``xla_deferred`` ladder and phase
    12's harness when given: ``mesh`` = {"sharded", "sharded_k3",
    "partitioned_sharded"}, ``options`` = {engine name: its phase-10
    result}, ``runner`` = {12's step: its counts}), phase 3's worst
    errors, phase 3b's certificate ratios and phase 3c's deterministic
    cases."""
    paths = [r6["v3"], r6["v1"], r6["v2"], r7, r8] + ([paged] if paged else [])
    paths += list((runner or {}).values())
    if mesh:
        paths += [mesh["sharded"], mesh["sharded"]["one_shard"], mesh["sharded_k3"],
                  mesh["partitioned_sharded"]]
    if options:
        paths += [dict(r, lane_bodies={n: {"wgmma": 0, "simt": 0}
                                       for n in kernels.lane_body_launches})
                  for r in options.values()]
    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "product_only_matmul_ms")
    entries = []
    for name, impl in (("packed_scan_v3", "v3"), ("packed_scan", "v1"),
                       ("packed_scan_v2", "v2"), ("bin_scan", None)):
        e = dict(name=name, route="cuda", **KERNELS[name], library=library)
        if impl is None:
            # ms / plain_ms / bound_ms: K4's own path, phase 5 (Dt=2048, R=2)
            r = r6["k4"]
            e.update(launches=r["launches"], bodies=r["bodies"],
                     max_abs_err=max(worst[name], r["max_abs_err"]),
                     ms=r["ms"], plain_ms=r["plain_ms"])
        else:
            r = r6[impl]
            e.update(launches=sum(p["launches"][name] for p in paths),
                     max_abs_err=max(worst[name], r["max_abs_err"]),
                     ms=r["ms"], plain_ms=r["plain_ms"], qps=r["qps"])
        # no single PyTorch call computes a masked, bin-wise top-R
        e.update(bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
                 certificate_error_ratio=cert[name],
                 deterministic_cases=deterministic[name],
                 product_only_matmul_ms=r["product_only_matmul_ms"])
        if "bound_fp32_simt_ms" in r:
            e.update(bound_fp32_simt_ms=r["bound_fp32_simt_ms"])
        if impl is not None and name in kernels.lane_body_launches:
            # ms / plain_ms / qps / bound_ms: the D=10⁶ lane path (Dt=8192, R=4)
            e.update(bodies={b: sum(p["lane_bodies"][name][b] for p in paths)
                             for b in ("wgmma", "simt")})
        if mesh and name == "packed_scan":
            # K3 per shard (phase 9b: 2×2 mesh, half a batch a q row)
            k3 = mesh["sharded_k3"]
            e.update(max_abs_err=max(e["max_abs_err"], k3["max_abs_err"]),
                     launches_sharded_k3=k3["launches"][name],
                     ms_shard_d1e6=k3["shard"]["ms"],
                     plain_ms_shard_d1e6=k3["shard"]["plain_ms"],
                     qps_sharded_k3_d1e6=k3["qps"],
                     shapes={"shard_d1e6_2x2": {k: k3["shard"][k] for k in timing}})
        if name == "packed_scan_v3":
            # ms / plain_ms / qps / bound_ms: the D=10⁶ fp32 batched path
            e.update(max_abs_err=max(e["max_abs_err"], r7["max_abs_err"],
                                     r8["max_abs_err"]),
                     ms_d1e7_bf16=r7["ms"], plain_ms_d1e7_bf16=r7["plain_ms"],
                     qps_d1e7=r7["qps"],
                     ms_window_d1e7_bf16=r8["window"]["ms"],
                     plain_ms_window_d1e7_bf16=r8["window"]["plain_ms"],
                     qps_partitioned_d1e7=r8["qps"],
                     bodies={b: sum(p["bodies"][b] for p in paths)
                             for b in ("wgmma", "simt")},
                     shapes={
                         "d1e6_fp32": {k: r6["v3"][k] for k in timing},
                         "d1e7_bf16": {k: r7[k] for k in timing},
                         "window_d1e7_bf16": {k: r8["window"][k] for k in timing},
                     })
            if paged:
                # K1 at the paged engine's window (phase 8, fp32 plane)
                e.update(max_abs_err=max(e["max_abs_err"], paged["max_abs_err"]),
                         ms_paged_window_d1e7_fp32=paged["window"]["ms"],
                         plain_ms_paged_window_d1e7_fp32=paged["window"]["plain_ms"],
                         qps_paged_d1e7=paged["qps"],
                         launches_paged=paged["launches"][name])
                e["shapes"]["paged_window_d1e7_fp32"] = {k: paged["window"][k]
                                                         for k in timing}
            if mesh:
                # K1 per shard: phase 9a (4 virtual shards, then 1) and 9c
                sh, ps = mesh["sharded"], mesh["partitioned_sharded"]
                e.update(max_abs_err=max(e["max_abs_err"], sh["max_abs_err"]),
                         ms_shard_d1e7_fp32=sh["shard"]["ms"],
                         plain_ms_shard_d1e7_fp32=sh["shard"]["plain_ms"],
                         launches_sharded=sh["launches"][name],
                         launches_sharded_1shard=sh["one_shard"]["launches"][name],
                         launches_partitioned_sharded=ps["launches"][name],
                         qps_sharded_d1e7=sh["qps"],
                         qps_sharded_1shard_d1e7=sh["one_shard"]["qps"],
                         qps_partitioned_sharded_d1e7=ps["qps"])
                e["shapes"]["shard_d1e7_fp32"] = {k: sh["shard"][k] for k in timing}
            if options:
                # phase 10: K1 on the repaired engines' paths and the
                # xla_deferred engine's rung 1
                e.update(launches_phase10={k: r["launches"][name]
                                           for k, r in options.items()},
                         qps_phase10={k: r["qps"] for k, r in options.items()})
            if runner:
                # phase 12: the dry run, the runner's median timed search
                # (in process and as a subprocess) and the latency tool
                e.update(launches_phase12={k: r["launches"][name]
                                           for k, r in runner.items()})
        entries.append(e)
    l2 = r7["level2"]
    # every path's level-2 launches ran the register body: want_level2_launches
    # and assert_k1_only hold each path to that
    n = sum(p["launches"]["level2_select"] for p in paths)
    entries.append(dict(
        name="level2_select", route="cuda", source="hvq_tpu_torch/csrc/level2_select.cu",
        # no TPU kernel: the JAX package's jnp reduce, which XLA runs
        replaces=None, computes="hvq_tpu/ops/topk.py:88", library=library,
        launches=n, bodies={"registers": n, "shared": 0},
        ms=l2["ms"], plain_ms=l2["plain_ms"], bound_ms=l2["bound_ms"],
        bound_by=l2["bound_by"], library_ms=None, select_ms=l2["select_ms"],
        plain_select_ms=l2["plain_select_ms"], max_abs_err=0.0,     # bit for bit
        deterministic_cases=deterministic["level2_select"],
        shapes={"d1e7_bf16": l2, "window_d1e7_bf16": r8["window"]["level2"],
                "d1e6_fp32": r6["v3"]["level2"]}))
    return entries


class Laps:
    """Each phase's seconds, logged as it ends."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()
        self.seconds = {}

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        self.seconds[phase] = round(now - self.t, 1)
        log(f"phase {phase}: {now - self.t:.1f} s (total {now - self.t0:.1f} s)")
        self.t = now


def main() -> int:
    card = probe()
    batched.binned_stream_topk = counting_selects(batched.binned_stream_topk)
    lap = Laps()
    build()
    lap("2")
    worst = {"packed_scan_v3": k1_vs_plain()}
    worst.update(lane_vs_plain())
    log(f"kernel vs plain: all cases ok, max_abs_err {worst}")
    log(f"bounds of the TPU probe scripts: {json.dumps(probe_bounds())}")
    lap("3")
    cert = {"packed_scan_v3": certificate_error()}
    for name in ("packed_scan", "packed_scan_v2"):
        cert[name] = certificate_error(name, 8192, 4, planes=("fp32",))
    cert["bin_scan"] = certificate_error("bin_scan", 2048, 2, planes=("fp32",))
    log(f"certificate error, share of the slack used (≤ 0.5): {cert}")
    deterministic = {name: determinism(name) for name in KERNELS}
    deterministic["level2_select"] = level2_determinism()
    lap("3b-3c")
    log("TPU probe kernels (phase 3d):")
    probes = probe_phase(os.path.basename(probe_kernels.build_info["path"]))
    lap("3d")
    r6, reuse_d1e6, lane_db = paths_d1e6()
    torch.cuda.empty_cache()
    lap("4-5")
    r7, reused = path_d1e7()
    lap("6")
    r8 = path_partitioned(reused)
    lap("7")
    partitioned_ids, index7 = r8.pop("ids"), r8.pop("index")
    ds, qs, eng6, ref, batched_ids = reused
    db6 = eng6.db           # phase 10a searches phase 6's database again
    del reused, eng6
    torch.cuda.empty_cache()
    r9 = path_paged(ds, qs, ref, batched_ids)
    paged_ids = r9.pop("ids")
    lap("8")
    r10 = path_ivf()
    lap("9 ivf")
    torch.cuda.reset_peak_memory_stats(DEV)
    mesh = {"sharded": path_sharded(ds, qs, ref, batched_ids)}
    sharded_ids = mesh["sharded"].pop("ids")
    mesh["sharded_k3"] = path_sharded_k3(*reuse_d1e6)
    mesh["partitioned_sharded"] = path_partitioned_sharded(ds, qs, ref, partitioned_ids)
    psharded_ids = mesh["partitioned_sharded"].pop("ids")
    lap("9a-9c")
    log("phase 10a: repair_bins=2 on the card")
    r10a = path_repair(
        ds, qs, ref, db6, index7,
        answers=dict(batched=batched_ids, partitioned=partitioned_ids, paged=paged_ids,
                     sharded=sharded_ids, partitioned_sharded=psharded_ids),
        bases=dict(batched=r7["ladder"], paged=r9["reruns"],
                   partitioned=dict(r8["route"]["ladder"], flagged=r8["route"]["suspects"],
                                    dense_straddling=r8["route"]["dense_straddling"]),
                   sharded=mesh["sharded"]["ladder"],
                   partitioned_sharded=dict(
                       mesh["partitioned_sharded"]["route"]["ladder"],
                       flagged=mesh["partitioned_sharded"]["route"]["suspects"],
                       dense_straddling=mesh["partitioned_sharded"]["route"]["dense_straddling"])))
    lap("10a")
    # phase 12 reuses the host rows and queries of phases 6-7
    del ref, batched_ids, partitioned_ids, paged_ids, sharded_ids, psharded_ids
    del db6, index7
    torch.cuda.empty_cache()
    log("phases 10b-10e: xla_deferred, the top-k strategies, bf16 storage, native + CLI")
    r10b = path_deferred(*reuse_d1e6, lane_db)
    r10c = path_strategies(*reuse_d1e6, lane_db)
    del lane_db
    torch.cuda.empty_cache()
    r10d = path_bf16_storage(*reuse_d1e6)
    del reuse_d1e6
    r10e = path_native_cli()
    lap("10b-10e")
    r11 = path_harness()
    lap("11")
    log(f"paged {r9['qps']:.1f} QPS, ivf {r10['qps']:.1f} QPS (recall {r10['recall']}), "
        f"sharded {mesh['sharded']['qps']:.1f} QPS ({MESH_SHARDS} virtual shards; "
        f"1 shard {mesh['sharded']['one_shard']['qps']:.1f}), sharded K3 "
        f"{mesh['sharded_k3']['qps']:.1f}, partitioned_sharded "
        f"{mesh['partitioned_sharded']['qps']:.1f}, harness runs {r11['run_s']}")
    log("phase 10 summary: " + json.dumps(dict(
        repair={k: dict(qps=v["qps"], ladder=v["ladder"], base_ladder=v["base_ladder"],
                        repair_phase=v["repair_phase"], terms=v["terms"])
                for k, v in r10a.items()},
        xla_deferred=r10b, strategies=r10c, bf16_storage=r10d, native_cli=r10e)))
    torch.cuda.empty_cache()
    log("phase 12: the dry run's capacity leg, the benchmark runner, the latency tool")
    r12 = path_runner(ds, qs)
    del ds, qs
    lap("12")
    log(f"phase 12 summary: runner {r12['bench_d1e7']['qps']} QPS (partitioned D=1e7), "
        f"{r12['bench_subprocess']['qps']} QPS (batched D=1e6, subprocess); latency "
        + json.dumps([{k: r[k] for k in ("engine", "batch", "p50_ms", "p95_ms", "p99_ms",
                                         "max_ms", "rerun_calls")}
                      for r in r12["latency"]["records"]]))
    log(f"phase seconds: {json.dumps(lap.seconds)}")
    library = os.path.basename(kernels.build_info["path"])
    runner = {k: r12[k] for k in ("dryrun", "bench_d1e7", "bench_subprocess", "latency")}
    entries = kernel_entries(r6, r7, r8, worst, cert, deterministic, library,
                             paged=r9, mesh=mesh, options=dict(r10a, xla_deferred=r10b),
                             runner=runner) + probes
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
