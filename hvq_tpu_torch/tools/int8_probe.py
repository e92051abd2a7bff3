"""The card's counterpart of ``experiments/int8_probe.py``: does the int8
product run at twice the bf16 rate, at the selection shapes?

    python -m hvq_tpu_torch.tools.int8_probe [--out chiprun_out/int8_probe.json]

The script's shape: q (B 256, 128) · d (NT 61, 128, Dt 16384), each tile's
product reduced to the min over each 128 contiguous columns, then the min
over the tiles ((B, 128), as the script's ``run``). Its variants, each
timed over REPS calls on distinct query sets:

* ``plain <variant> mm+min``: the plain PyTorch version of each variant
  (the script's XLA rows, one per variant);
* ``kernel <variant>`` for each of ``probe_kernels.INT8_PROBE_VARIANTS``
  (the script's Mosaic rows): the hand kernel, bf16 or s8 ``wgmma``;
* ``int8 transpose only``: the int8 kernel without its product. s8 wgmma
  reads only K-major operands and d is MN-major here, so the int8 path
  transposes each bin in shared memory; this times that and the loads;
* yardsticks of the product alone, not the same function: ``torch.matmul``
  (bf16, one call over all tiles) and ``torch._int_mm`` (int8, one call a
  tile).

Each line gives ms a call and the rate 2·B·128·Dt·NT / time in TOP/s,
beside the bound (the bytes of q and d read once and the (NT, B, 128)
minima written, at 3.35 TB/s, against the operations at 989 TFLOP/s bf16
or 1979 TOP/s int8). Every kernel variant is first held against its plain
version on the first query set: int8 bit for bit, bf16 within
128·2⁻²⁴·Σ|q_k·d_k| of each entry. Prints one JSON object, also written
to ``--out``. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import torch

from hvq_tpu_torch.ops import probe_kernels
from hvq_tpu_torch.ops.distance import mm_nt, require_ieee_fp32
from hvq_tpu_torch.tools.card import (PEAK_BF16, PEAK_INT8, bound, card_line, event_ms,
                                      require_card)

B, K, DT, NT = 256, 128, 16384, 61    # experiments/int8_probe.py:28
REPS = 5
REPLACES = "experiments/int8_probe.py:83"
SOURCE = "hvq_tpu_torch/csrc/probes.cu"
VARIANTS = tuple(probe_kernels.INT8_PROBE_VARIANTS)


def probe_bound(variant: str, b: int = B, dt: int = DT, nt: int = NT) -> dict:
    """chip_smoke's rule for the probe: q and d read once, the (nt, b, 128)
    4-byte minima written; 2·b·128·dt·nt operations at the operand type's
    peak."""
    size, peak = (2, PEAK_BF16) if variant.startswith("bf16") else (1, PEAK_INT8)
    nbytes = (b + nt * dt) * K * size + nt * b * (dt // 128) * 4
    return bound(2 * b * K * dt * nt, peak, nbytes)


def inputs(seed: int = 0, b: int = B, dt: int = DT, nt: int = NT, sets: int = REPS + 1):
    """The script's data made on the card: ``sets`` query sets and one d,
    standard normal in bf16 and integers in [−127, 127) in int8."""
    dev = require_card()
    g = torch.Generator(device=dev).manual_seed(seed)
    qf = [torch.randn((b, K), device=dev, generator=g).to(torch.bfloat16)
          for _ in range(sets)]
    df = torch.randn((nt, K, dt), device=dev, generator=g).to(torch.bfloat16)
    qi = [torch.randint(-127, 127, (b, K), device=dev, generator=g, dtype=torch.int8)
          for _ in range(sets)]
    di = torch.randint(-127, 127, (nt, K, dt), device=dev, generator=g, dtype=torch.int8)
    return dict(bf16=(qf, df), int8=(qi, di))


def operands(data, variant):
    return data["bf16" if variant.startswith("bf16") else "int8"]


def agreement(variant: str, q, d) -> float:
    """The kernel against its plain version: the largest |Δ| (0 required
    for int8; bf16 within 128·2⁻²⁴·Σ|q_k·d_k| of each entry)."""
    got = probe_kernels.int8_probe(q, d, variant)
    want = probe_kernels.int8_probe_plain(q, d, variant)
    err = (got.double() - want.double()).abs()
    if variant.startswith("int8"):
        if not torch.equal(got, want):
            raise AssertionError(f"int8_probe {variant} differs from its plain version")
    else:
        nt, b, nbin = want.shape
        tol = torch.stack([mm_nt(q.float().abs(), d[t].float().abs().t())
                           .view(b, nbin, 128).amax(2) for t in range(nt)])
        if not bool((err <= 128 * 2.0 ** -24 * tol).all()):
            raise AssertionError(f"int8_probe {variant} outside its tolerance")
    for _ in range(2):
        if not torch.equal(got.view(torch.int32),
                           probe_kernels.int8_probe(q, d, variant).view(torch.int32)):
            raise AssertionError(f"int8_probe {variant} rerun differs")
    return float(err.max())


def check(data) -> dict:
    """Every kernel variant against its plain version, and rerun twice bit
    for bit, on the first query set; returns variant → max |Δ|."""
    require_ieee_fp32(require_card())
    out = {}
    for variant in VARIANTS:
        qs, d = operands(data, variant)
        out[variant] = agreement(variant, qs[0], d)
        print(f"kernel {variant} vs plain: max_abs_err={out[variant]:.3g}; "
              "rerun twice bit-identical", flush=True)
    return out


def _line(name: str, ms: float) -> None:
    flops = 2 * B * K * DT * NT
    print(f"{name:34s} {ms:8.4f} ms  {flops / ms / 1e9:7.1f} Tops", flush=True)


def _timed(fn, qs, d) -> float:
    """ms of ``fn(q, d)`` a call, over REPS calls cycling distinct query
    sets (the first warms up)."""
    turn = itertools.count()
    return event_ms(lambda: fn(qs[1 + next(turn) % REPS], d), REPS)


def int_mm_tiles(d):
    """``torch._int_mm`` over each tile of d, as d lies or, if cuBLASLt
    refuses that layout, on a column-major copy made beforehand; returns
    (fn(q), the layout used)."""
    q = torch.zeros((B, K), dtype=torch.int8, device=d.device)
    try:
        torch._int_mm(q, d[0])
        return (lambda q: [torch._int_mm(q, d[t]) for t in range(d.shape[0])]), "row-major"
    except RuntimeError:
        dc = [d[t].t().contiguous().t() for t in range(d.shape[0])]
        torch._int_mm(q, dc[0])
        return (lambda q: [torch._int_mm(q, x) for x in dc]), "column-major copy"


def measure(data) -> dict:
    """Time every variant of the script, the transpose and the yardsticks."""
    res = {v: {} for v in VARIANTS}
    for variant in VARIANTS:
        ms = _timed(lambda q, d: probe_kernels.int8_probe_plain(q, d, variant).amin(0),
                    *operands(data, variant))
        _line(f"plain {variant} mm+min", ms)
        res[variant]["plain_ms"] = ms
    for variant in VARIANTS:
        ms = _timed(lambda q, d: probe_kernels.int8_probe(q, d, variant).amin(0),
                    *operands(data, variant))
        _line(f"kernel {variant} mm+min", ms)
        res[variant].update(ms=ms, **probe_bound(variant))
    qi, di = data["int8"]
    ms = _timed(lambda q, d: probe_kernels.int8_probe(q, d, "int8->i32", product=False), qi, di)
    _line("kernel int8 transpose only (no product)", ms)
    res["int8->i32"]["transpose_only_ms"] = ms
    qf, df = data["bf16"]
    ms = _timed(lambda q, d: torch.matmul(q, d), qf, df)
    _line("yardstick torch.matmul bf16 (product only)", ms)
    res["bf16->f32"]["product_only_ms"] = ms
    int_mm, layout = int_mm_tiles(di)
    ms = _timed(lambda q, d: int_mm(q), qi, di)
    _line(f"yardstick torch._int_mm, {layout} (product only)", ms)
    for variant in VARIANTS[1:]:
        res[variant].update(product_only_ms=ms, product_only_layout=layout)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/int8_probe.json")
    args = ap.parse_args(argv)
    dev = require_card()
    print(f"device: {torch.cuda.get_device_name(dev)} ({card_line()})", flush=True)
    data = inputs()
    res = dict(max_abs_err=check(data), ms=measure(data))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
