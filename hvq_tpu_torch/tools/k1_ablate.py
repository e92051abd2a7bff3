"""K1's tensor-core body with its product or its epilogue taken out, timed
beside the shipped kernel at two main-path shapes on the card.

    python -m hvq_tpu_torch.tools.k1_ablate [--out chiprun_out/k1_ablate.json]

Each variant is ``csrc/packed_scan_v3.cu`` with one anchored edit, built
with the library's own nvcc flags (beside ``csrc/lane_scan.cu``, so it is
a whole kernel library) into ``hvq_tpu_torch/_build/ablate/``:

* ``base``: the source as shipped;
* ``no_epilogue``: each slice skips the distance, mask and top-R insert;
* ``no_product``: each slice issues no ``wgmma`` (on the fp32 plane the
  hi/lo split of the slice still runs).

Both edits guard the code with a test on ``sn`` whose outcome never
changes, so it stays compiled. The variants' outputs are wrong by design;
``base`` is run five times and held bit for bit. Shapes: B=1024,
Dt=16384, R=3, half the queries type 0 and half a wide type-2 range, as
the partitioned engine's full batches; 611 tiles (D=10⁷) on the bf16
plane and 62 tiles (D=10⁶) on the fp32 plane. Each variant is timed with
CUDA events over 3 launches after one warm-up, in two rounds of opposite
order. Prints one JSON object and writes it to ``--out``. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor

import torch

from hvq_tpu_torch.ops import kernels
from hvq_tpu_torch.ops.masks import query_predicate_fields

_SOID = "    const int* soid = reinterpret_cast<const int*>(sdn + NB);\n"
_ARRIVE = "    mbar_arrive(empty + 8 * st);\n  }\n"
_PRODUCT = "    if (kBf16) {\n      product<NB, true>(acc, qhi, base + P::ring"
VARIANTS = {
    "base": (),
    "no_epilogue": ((_SOID, _SOID + "    if (a.sn < 0) {          // never\n"),
                    (_ARRIVE, "    }\n" + _ARRIVE)),
    "no_product": ((_PRODUCT, "    if (a.sn >= 0) {         // always\n    } else"
                    + _PRODUCT[3:]),),
}
SHAPES = (("bf16", 611), ("fp32", 62))


def build() -> dict:
    """Every variant's library, compiled in parallel; name → ctypes library."""
    src = kernels._SOURCES[0].read_text()
    out = kernels.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = kernels.nvcc_path()

    def one(name):
        text = src
        for anchor, edit in VARIANTS[name]:
            if text.count(anchor) != 1:
                raise RuntimeError(f"{name}: anchor not found once in the source")
            text = text.replace(anchor, edit)
        cu = out / name / kernels._SOURCES[0].name
        cu.parent.mkdir(exist_ok=True)
        cu.write_text(text)
        so = out / f"lib_{name}.so"
        kernels._compile(nvcc, so, sources=(cu, kernels._SOURCES[1]))
        return name, kernels._load(so)

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(pool.map(one, VARIANTS))


def inputs(plane: str, tiles: int, B: int = 1024, seed: int = 1):
    """Scan inputs on the card, made there from ``seed``."""
    dev = torch.device("cuda")
    n_pad = tiles * 16384
    g = torch.Generator(device=dev).manual_seed(seed)
    Vf = torch.rand((n_pad, 128), device=dev, generator=g) * 12 - 6
    Vf[:, 100:] = 0
    dn = (Vf * Vf).sum(1)
    Vs = Vf.to(torch.bfloat16) if plane == "bf16" else Vf
    del Vf
    C = torch.randint(0, 1000, (n_pad,), device=dev, generator=g).float()
    T = torch.rand(n_pad, device=dev, generator=g)
    oid = torch.arange(n_pad, dtype=torch.int32, device=dev)
    qV = torch.rand((B, 128), device=dev, generator=g) * 12 - 6
    qV[:, 100:] = 0
    qtype = (torch.rand(B, device=dev, generator=g) < 0.5).float() * 2
    fields = query_predicate_fields(
        qtype, torch.zeros(B, device=dev), torch.rand(B, device=dev, generator=g) * 0.3,
        0.5 + torch.rand(B, device=dev, generator=g) * 0.5)
    return (Vs, C, T, dn, oid, qV, *fields, n_pad)


def time_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def ablate() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the ablation runs only on a GPU")
    libs = build()
    shipped = kernels._lib
    res = dict(device=torch.cuda.get_device_name(0), shapes={})
    kw = dict(db_tile=16384, bin_top=3)
    try:
        for plane, tiles in SHAPES:
            args = inputs(plane, tiles)
            times = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    kernels._lib = libs[name]
                    times[name].append(time_ms(lambda: kernels.packed_scan_v3(*args, **kw)))
            kernels._lib = libs["base"]
            first = kernels.packed_scan_v3(*args, **kw)
            for _ in range(4):
                again = kernels.packed_scan_v3(*args, **kw)
                if not all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                           for x, y in zip(first, again)):
                    raise AssertionError(f"base K1 is not deterministic [{plane}]")
                del again
            res["shapes"][f"{plane} {tiles} tiles"] = dict(ms=times, base_bit_identical_runs=5)
            del args, first
            torch.cuda.empty_cache()
    finally:
        kernels._lib = shipped
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/k1_ablate.json")
    args = ap.parse_args(argv)
    res = ablate()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
