"""The card's counterpart of ``experiments/pallas_probe.py``: a hand kernel
builds and runs (``_trivial``, o = 2·x), then K3 is timed against the plain
lane scan and their agreement reported as the script reports it.

    python -m hvq_tpu_torch.tools.pallas_probe [--out chiprun_out/pallas_probe.json]

``_trivial`` runs on a (256, 128) fp32 array, held bit for bit against
``x * 2`` (its plain version, which is also the one PyTorch call that
computes it), both timed, beside its bound (one read and one write of the
array at the HBM rate). Then, at the script's shape (B 256, Dt 8192, 128
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
import time

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


def trivial_time(seed: int = 0, reps: int = 100) -> dict:
    dev = require_card()
    x = torch.randn(TRIVIAL_SHAPE, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
    ms = event_ms(lambda: probe_kernels.trivial(x), reps)
    plain_ms = event_ms(lambda: probe_kernels.trivial_plain(x), reps)
    library_ms = event_ms(lambda: x * 2, reps)
    res = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **trivial_bound())
    print(f"trivial {ms:.5f} ms, plain {plain_ms:.5f} ms, x*2 {library_ms:.5f} ms, "
          f"bound {res['bound_ms']:.7f} ms ({res['bound_by']})", flush=True)
    return res


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
    args = ap.parse_args(argv)
    dev = require_card()
    print(f"device: {torch.cuda.get_device_name(dev)} ({card_line()})", flush=True)
    res = dict(trivial=dict(**trivial_check(), **trivial_time()), k3=k3_check())
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
