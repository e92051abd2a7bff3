"""The card's counterpart of ``experiments/v3_anatomy.py``: K1 cut into
stages, to see which part of its epilogue costs what.

    python -m hvq_tpu_torch.tools.v3_anatomy [--out chiprun_out/v3_anatomy.json]

The script's shape: B = 1024 queries a batch, G = 4 batches a group, 61
tiles of 16384 rows (999424 rows), standard normal rows and queries in all
128 lanes, C in 0..999, T in U(−3, 3), half the queries with each
predicate, sample limit = all rows; made on the card from a seed. The
int8 plane quantizes the fp32 rows as the script does (clip(round(x·127/6),
±127)). Each of the script's 15 variants (:data:`SPECS`, v3_anatomy.py:
257-273), and four more that cut K1 on the bf16 plane (:data:`EXTRA_SPECS`),
runs ``probe_kernels.k1_anatomy`` (the shared tensor-core body stopped at
the stage; ``mmc<CH>`` is mm at db_tile = CH):

1. held against its plain version on the first batch (int8 bit for bit;
   the min stages within the product's fp32 summation slack; the packed
   stages by ``utils.check.scan_agreement``, one key quantum plus the
   fp32-plane certificate slack) and rerun twice bit for bit;
2. timed with CUDA events over G·REPS launches on distinct query batches,
   printed as the script prints it (ms a batch, GB/s of the fp32 plane's
   bytes, QPS), beside its bound and its plain version's time.

The bound counts what the stage's function needs: the plane, the queries
and the int32 output for mm/mmb/mmc; dist adds ‖d‖² and ‖q‖²; mask, pack
and full also C, T, oid and the predicates; the operations are the 3 (fp32
plane) or 1 (bf16, int8) passes of 2·B·rows·128 at the bf16 or int8 peak.
Prints one JSON object, also written to ``--out``. Needs a CUDA device and
nvcc.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import torch

from hvq_tpu_torch.models.batched import _CERT_REL_MM
from hvq_tpu_torch.ops import probe_kernels
from hvq_tpu_torch.ops.distance import require_ieee_fp32
from hvq_tpu_torch.ops.masks import query_predicate_fields
from hvq_tpu_torch.ops.scan import decode_keys
from hvq_tpu_torch.ops.topk import BIN
from hvq_tpu_torch.tools.card import (PEAK_BF16, PEAK_INT8, bound, card_line, event_ms,
                                      require_card)
from hvq_tpu_torch.utils.check import scan_agreement

B, G, DT, NT, REPS = 1024, 4, 16384, 61, 3   # experiments/v3_anatomy.py:29-34
NROWS = NT * DT
REPLACES = "experiments/v3_anatomy.py:189"
SOURCE = "hvq_tpu_torch/csrc/k1_anatomy.cu"
# (name, stage, R, plane): experiments/v3_anatomy.py:257-273, planes named.
SPECS = (
    ("mm (3-pass bf16)", "mm", 1, "fp32"),
    ("dist", "dist", 1, "fp32"),
    ("mask", "mask", 1, "fp32"),
    ("pack R2 nomask", "pack", 2, "fp32"),
    ("full R1", "full", 1, "fp32"),
    ("full R2 (ship)", "full", 2, "fp32"),
    ("full R4", "full", 4, "fp32"),
    ("bf16 mm (1-pass)", "mm", 1, "bf16"),
    ("bf16 full R2", "full", 2, "bf16"),
    ("bf16 full R4", "full", 4, "bf16"),
    ("int8 mm (1-pass)", "mm", 1, "int8"),
    ("int8 full R2", "full", 2, "int8"),
    ("bf16 mm+bf16min", "mmb", 1, "bf16"),
    ("bf16 mm chunked 2048", "mmc2048", 1, "bf16"),
    ("bf16 mm chunked 4096", "mmc4096", 1, "bf16"),
)
# Not in the script: its dist, mask and pack stages run on the fp32 plane
# only, whose slice split also takes CUDA-core time. These cut K1 where it
# spends most, the bf16 plane (R 3: K1's R at D = 10⁷).
EXTRA_SPECS = (
    ("bf16 dist", "dist", 1, "bf16"),
    ("bf16 mask", "mask", 1, "bf16"),
    ("bf16 pack R2 nomask", "pack", 2, "bf16"),
    ("bf16 full R3", "full", 3, "bf16"),
)
ALL_SPECS = SPECS + EXTRA_SPECS


def anatomy_bound(stage: str, plane: str, b: int = B, rows: int = NROWS,
                  R: int = 1) -> dict:
    """The least time for one launch of ``stage`` on ``plane`` (see the
    module docstring); at the shipped full R2 it is chip_smoke's
    ``probe_bounds`` figure."""
    size, passes, peak = {"fp32": (4, 3, PEAK_BF16), "bf16": (2, 1, PEAK_BF16),
                          "int8": (1, 1, PEAK_INT8)}[plane]
    q_bytes = 128 * (1 if plane == "int8" else 2 * 2)      # int8, or bf16 hi + lo
    row_bytes, query_bytes = 128 * size, q_bytes
    if not stage.startswith("mm"):
        row_bytes += 4                                     # ‖d‖²
        query_bytes += 4                                   # ‖q‖²
    if stage in ("mask", "pack", "full"):
        row_bytes += 12                                    # C, T, oid
        query_bytes += 20                                  # ac, v, at, l, r
    nbytes = rows * row_bytes + b * query_bytes + b * (rows // BIN) * R * 4
    return bound(passes * 2 * b * rows * 128, peak, nbytes)


def inputs(seed: int = 0, b: int = B, nt: int = NT, dt: int = DT, batches: int = 1 + REPS * G):
    """The script's data on the card (v3_anatomy.py:218-237): the planes,
    the row attributes and ``batches`` query batches with one predicate set."""
    dev = require_card()
    g = torch.Generator(device=dev).manual_seed(seed)
    n = nt * dt
    Vp = torch.randn((n, 128), device=dev, generator=g)
    planes = dict(fp32=Vp, bf16=Vp.to(torch.bfloat16), int8=probe_kernels.quantize_i8(Vp))
    C = torch.floor(torch.rand(n, device=dev, generator=g) * 1000)
    T = torch.rand(n, device=dev, generator=g) * 6 - 3
    dn = (Vp * Vp).sum(1)
    oid = torch.arange(n, dtype=torch.int32, device=dev)
    qs = [torch.randn((b, 128), device=dev, generator=g) for _ in range(batches)]
    ac = torch.rand(b, device=dev, generator=g) < 0.5
    at = torch.rand(b, device=dev, generator=g) < 0.5
    v = torch.floor(torch.rand(b, device=dev, generator=g) * 1000)
    l = torch.rand(b, device=dev, generator=g) * -3
    r = torch.rand(b, device=dev, generator=g) * 3
    fields = query_predicate_fields(ac.int() + 2 * at.int(), v, l, r)
    return dict(planes=planes, rows=(C, T, dn, oid), qs=qs, fields=fields, sn=n, db_tile=dt)


def _args(data, plane, q):
    return (data["planes"][plane], *data["rows"], q, *data["fields"], data["sn"])


def agreement(stage: str, plane: str, R: int, args, db_tile: int) -> float:
    """The kernel against its plain version on ``args``; raises when they
    disagree, returns the largest |Δ| of the values compared."""
    kw = dict(stage=stage, db_tile=db_tile, bin_top=R)
    got = probe_kernels.k1_anatomy(*args, **kw)
    want = probe_kernels.k1_anatomy_plain(*args, **kw)
    tag = f"k1_anatomy {plane} {stage} R{R}"
    if plane == "int8":
        if not torch.equal(got, want):
            raise AssertionError(f"{tag} differs from its plain version")
        return 0.0
    dn, qV = args[3], args[5]
    tile = probe_kernels.anatomy_stage(stage, db_tile, R, plane)[1]
    slack = _CERT_REL_MM * ((qV * qV).sum(1) + float(dn.max()))          # (B,)
    if stage in ("pack", "full"):
        a = scan_agreement(*decode_keys(got, tile, R), *decode_keys(want, tile, R),
                           R, tile // BIN, (qV * qV).sum(1), float(dn.max()), _CERT_REL_MM)
        if not a["ok"]:
            raise AssertionError(f"{tag} disagrees with its plain version: {a}")
        return a["max_abs_err"]
    # The min stages: entry 0 of each bin holds the min's fp32 bits, the
    # rest zeros. Two fp32 summation orders of the same bf16 products (the
    # 3-pass chain in one accumulator against three sums) stay within half
    # the fp32-plane slack in q·d, the whole of it in the distance (−2·q·d),
    # plus an ulp of the sum; mmb's bf16 rounding may then move one bf16 ulp.
    B = got.shape[0]
    g4, w4 = got.view(B, -1, R, tile // BIN), want.view(B, -1, R, tile // BIN)
    if not bool((g4[:, :, 1:] == 0).all()):
        raise AssertionError(f"{tag}: entries past the first are not zero")
    gv, wv = g4[:, :, 0].view(torch.float32), w4[:, :, 0].view(torch.float32)
    tol = slack[:, None, None] * (0.5 if stage.startswith("mm") else 1.0)
    tol = tol + wv.abs() * (2.0 ** -7 if stage == "mmb" else 2.0 ** -23)
    both_inf = torch.isinf(gv) & torch.isinf(wv)
    err = (gv - wv).abs().masked_fill(both_inf, 0.0)
    if not bool(((err <= tol) | both_inf).all()):
        raise AssertionError(f"{tag}: max |Δ| {float(err.max())} outside its tolerance")
    return float(err.max())


def check(data, specs=ALL_SPECS) -> dict:
    """Each spec against its plain version on the first batch, and rerun
    twice bit for bit; returns name → max |Δ|."""
    require_ieee_fp32(require_card())
    out = {}
    for name, stage, R, plane in specs:
        args = _args(data, plane, data["qs"][0])
        out[name] = agreement(stage, plane, R, args, data["db_tile"])
        kw = dict(stage=stage, db_tile=data["db_tile"], bin_top=R)
        first = probe_kernels.k1_anatomy(*args, **kw)
        for _ in range(2):
            if not torch.equal(first, probe_kernels.k1_anatomy(*args, **kw)):
                raise AssertionError(f"{name}: rerun differs")
        print(f"{name:26s} vs plain: max_abs_err={out[name]:.3g}; rerun twice "
              "bit-identical", flush=True)
    return out


def measure(data, specs=ALL_SPECS, plain_reps: int = 1) -> dict:
    """Each spec timed as the script times it, beside its bound and its
    plain version's time."""
    b, rows = data["qs"][0].shape[0], data["sn"]
    gb = rows * 512 / 1e9
    res = {}
    for name, stage, R, plane in specs:
        kw = dict(stage=stage, db_tile=data["db_tile"], bin_top=R)
        turn = itertools.count()
        batch = lambda: _args(data, plane, data["qs"][1 + next(turn) % (REPS * G)])
        ms = event_ms(lambda: probe_kernels.k1_anatomy(*batch(), **kw), REPS * G)
        plain_ms = event_ms(lambda: probe_kernels.k1_anatomy_plain(*batch(), **kw),
                            plain_reps)
        res[name] = dict(stage=stage, R=R, plane=plane, ms=ms, plain_ms=plain_ms,
                         **anatomy_bound(stage, plane, b, rows, R))
        print(f"{name:26s} {ms:7.3f} ms/batch {gb / ms * 1e3:6.1f} GB/s "
              f"{b / ms * 1e3:8.0f} QPS  bound {res[name]['bound_ms']:.3f} ms "
              f"({res[name]['bound_by']})  plain {plain_ms:.1f} ms", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/v3_anatomy.json")
    args = ap.parse_args(argv)
    dev = require_card()
    print(f"device: {torch.cuda.get_device_name(dev)} ({card_line()}) rows={NROWS} "
          f"B={B} G={G} DT={DT}", flush=True)
    data = inputs()
    res = dict(max_abs_err=check(data), ms=measure(data))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
