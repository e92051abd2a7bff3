"""K1's tensor-core body with its product or its epilogue taken out, timed
beside the shipped kernel at two main-path shapes on the card; K3 and K2
timed at other tensor-core shapes; and K1 held bit for bit against the
library built from another source tree.

    python -m hvq_tpu_torch.tools.k1_ablate [--out chiprun_out/k1_ablate.json]
        [--reference DIR]

Each variant is the shared tensor-core body ``csrc/scan_wgmma.cuh`` with
one anchored edit, built with the library's own nvcc flags beside copies
of both sources that include it (so it is a whole kernel library) into
``hvq_tpu_torch/_build/ablate/``:

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
CUDA events over 10 launches after one warm-up, in four rounds of
alternating order. ``base`` (and the reference) are also timed with every
query type 0 (``open``: each warpgroup runs the predicate-free epilogue)
and with every query type 2 (``predicated``), under ``ms_by_mix``.

``--reference DIR``: K1 is also built from ``DIR/packed_scan_v3.cu`` (with
any ``*.cuh`` beside it; for example an earlier commit's
``hvq_tpu_torch/csrc``, unpacked with ``git archive``) and run on the same
inputs as the shipped K1: R = 3 and the rung-1 R = 6 at both shapes, and
on the bf16 plane a 305-tile window at row0 = 100 tiles, as the
partitioned engine's windowed batches, each with the three query mixes
(half, open, predicated). Every output must be bit-identical
(``reference_bit_identical`` counts the cases), and the reference is timed
beside the variants in the same rounds (``ms["reference"]``). ``ptxas``
gives the registers and spills of every K1 tensor-core instantiation of
``base`` and the reference, from nvcc's report.

The lane shapes: K3's and K2's tensor-core shape (bins a CTA for R ≤ 4,
consumer warpgroups sharing each slice and its split, ring stages) is one
line of ``csrc/lane_scan.cu``; each shape of ``LANE_SHAPES`` is that line
edited, built as a whole library. Inputs: B = 1024 over 123 tiles of 8192
rows (the D = 10⁶ lane engine's n_pad), fp32 plane; R = 4 (the lane
paths) and R = 8 (the lane rung 1). Each (kernel, R, shape) is timed in
the same rounds and held bit for bit to ``base``'s output.

Prints one JSON object and writes it to ``--out``. Needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from hvq_tpu_torch.ops import kernels
from hvq_tpu_torch.ops.masks import query_predicate_fields
from hvq_tpu_torch.tools.card import event_ms

_SOID = "    const int* soid = reinterpret_cast<const int*>(sdn + NB);\n"
_ARRIVE = "    mbar_arrive(empty + 8 * st);\n  }\n"
_PRODUCT = "    if constexpr (kPasses == 1) {\n      product<NB, true>(acc, qa, base + P::ring"
VARIANTS = {
    "base": (),
    "no_epilogue": ((_SOID, _SOID + "    if (a.sn < 0) {          // never\n"),
                    (_ARRIVE, "    }\n" + _ARRIVE)),
    "no_product": ((_PRODUCT, "    if (a.sn >= 0) {         // always\n    } else"
                    + _PRODUCT[3:]),),
}
SHAPES = (("bf16", 611), ("fp32", 62))
# K3's and K2's tensor-core shape, one line of csrc/lane_scan.cu: (bins a
# CTA for R ≤ 4, warpgroups, stages); "base" is the shipped one.
LANE_SHAPE = "  constexpr int kNB4 = {}, kWG = {}, kStages = {};\n"
LANE_SHAPES = {"base": (32, 2, 3), "32 1 3": (32, 1, 3), "32 1 2": (32, 1, 2),
               "64 2 2": (64, 2, 2)}
LANE_TILE, LANE_TILES = 8192, 123


def rounds(names: list) -> list:
    """The timing order: four rounds, alternating forward and backward."""
    return (names + names[::-1]) * 2


_HEADER = kernels._HEADERS[0]
_K1 = ("hvq_packed_scan_v3", "hvq_packed_scan_v3_body")


def edited(path: Path, edits) -> str:
    """The text of ``path`` with each (anchor, edit) applied; every anchor
    must occur exactly once."""
    text = path.read_text()
    for anchor, edit in edits:
        if text.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in {path.name}: {anchor!r}")
        text = text.replace(anchor, edit)
    return text


def lane_shape_edit(name: str):
    """The anchored edit of csrc/lane_scan.cu that builds lane shape ``name``."""
    return ((LANE_SHAPE.format(*LANE_SHAPES["base"]),
             LANE_SHAPE.format(*LANE_SHAPES[name])),)


def ptxas_report(log: str) -> dict:
    """Registers and spills of each K1 tensor-core entry (layout Axis1) in
    an nvcc ``-Xptxas -v`` log; mangled name → one line."""
    res, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and ("Axis1" in fn or "k1_wgmma" in fn) and (
                "spill" in line or "Used" in line):
            res[fn] = (res.get(fn, "") + " " + line.split(":")[-1].strip()).strip()
    return res


def build(reference: str | None = None):
    """Every variant's library (and the reference's K1, and each lane
    shape), compiled in parallel; (name → ctypes library, name → ptxas
    report of K1's tensor-core entries)."""
    out = kernels.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = kernels.nvcc_path()

    def one(name, header_edits=(), lane_edits=()):
        tree = out / name.replace(" ", "_")
        tree.mkdir(exist_ok=True)
        (tree / _HEADER.name).write_text(edited(_HEADER, header_edits))
        for cu in kernels._SOURCES:
            (tree / cu.name).write_text(
                edited(cu, lane_edits if cu.name == "lane_scan.cu" else ()))
        so = out / f"lib_{tree.name}.so"
        _, log = kernels._compile(
            nvcc, so, sources=tuple(tree / cu.name for cu in kernels._SOURCES))
        return name, kernels._load(so), ptxas_report(log)

    def ref():
        tree = out / "reference"
        shutil.rmtree(tree, ignore_errors=True)
        tree.mkdir()
        for f in Path(reference).iterdir():
            if f.name == "packed_scan_v3.cu" or f.suffix == ".cuh":
                shutil.copyfile(f, tree / f.name)
        so = out / "lib_reference.so"
        _, log = kernels._compile(nvcc, so, sources=(tree / "packed_scan_v3.cu",))
        return "reference", kernels._load(so, entries=_K1), ptxas_report(log)

    jobs = [lambda n=n: one(n, VARIANTS[n]) for n in VARIANTS]
    jobs += [lambda n=n: one(f"lane {n}", lane_edits=lane_shape_edit(n))
             for n in LANE_SHAPES if n != "base"]
    jobs += [ref] if reference else []
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: job(), jobs))
    return ({n: lib for n, lib, _ in built},
            {n: rep for n, _, rep in built if n in ("base", "reference")})


MIXES = ("half", "open", "predicated")


def inputs(plane: str, tiles: int, B: int = 1024, seed: int = 1, db_tile: int = 16384):
    """Scan inputs on the card over ``tiles`` tiles of ``db_tile`` rows, made
    there from ``seed``."""
    dev = torch.device("cuda")
    n_pad = tiles * db_tile
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


def with_mix(args: tuple, mix: str) -> tuple:
    """``args`` of :func:`inputs` with their queries' predicates set by
    ``mix``: "half" as made, "open" every query type 0, "predicated" every
    query type 2 at its own range."""
    if mix == "half":
        return args
    active_t = torch.full_like(args[8], mix == "predicated")
    return args[:8] + (active_t,) + args[9:]


def same_bits(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def reference_cases(plane: str):
    """The (bin_top, row0, ntw) cases held bit for bit against the reference."""
    cases = [(3, None, None), (6, None, None)]
    if plane == "bf16":
        cases.append((3, 100 * 16384, 305))
    return cases


def lane_shapes(libs: dict) -> dict:
    """K3 and K2 at each lane shape: (kernel R) → shape → ms per round."""
    res = {}
    args = inputs("fp32", LANE_TILES, db_tile=LANE_TILE)
    shapes = list(LANE_SHAPES)
    for name in ("packed_scan", "packed_scan_v2"):
        fn = getattr(kernels, name)
        for R in (4, 8):
            kw = dict(db_tile=LANE_TILE, bin_top=R)
            kernels._lib = libs["base"]
            want = fn(*args, **kw)
            times = {shape: [] for shape in shapes}
            for shape in rounds(shapes):
                kernels._lib = libs["base" if shape == "base" else f"lane {shape}"]
                times[shape].append(event_ms(lambda: fn(*args, **kw), 10))
                if not same_bits(fn(*args, **kw), want):
                    raise AssertionError(f"{name} R={R}: lane shape {shape} differs")
            res[f"{name} R={R}"] = times
            del want
    return res


def ablate(reference: str | None = None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the ablation runs only on a GPU")
    libs, ptxas = build(reference)
    ref = libs.get("reference")
    shipped = kernels._lib
    res = dict(device=torch.cuda.get_device_name(0), ptxas=ptxas, shapes={})
    kw = dict(db_tile=16384, bin_top=3)
    k1_libs = [name for name in libs if not name.startswith("lane ")]
    try:
        for plane, tiles in SHAPES:
            args = inputs(plane, tiles)
            if ref is not None:
                checked = 0
                for (R, row0, ntw), mix in itertools.product(reference_cases(plane), MIXES):
                    kr = dict(db_tile=16384, bin_top=R, row0=row0, ntw=ntw)
                    kernels._lib = libs["base"]
                    mine = kernels.packed_scan_v3(*with_mix(args, mix), **kr)
                    kernels._lib = ref
                    theirs = kernels.packed_scan_v3(*with_mix(args, mix), **kr)
                    if not same_bits(mine, theirs):
                        raise AssertionError(f"K1 differs from the reference "
                                             f"[{plane} R={R} row0={row0} {mix}]")
                    checked += 1
                    del mine, theirs
                res.setdefault("reference_bit_identical", {})[plane] = checked
            times = {name: [] for name in k1_libs}
            for name in rounds(k1_libs):
                kernels._lib = libs[name]
                times[name].append(event_ms(lambda: kernels.packed_scan_v3(*args, **kw), 10))
            by_mix = {}
            for mix in MIXES[1:]:
                mixed = with_mix(args, mix)
                names = [n for n in ("base", "reference") if n in libs]
                by_mix[mix] = {name: [] for name in names}
                for name in rounds(names):
                    kernels._lib = libs[name]
                    by_mix[mix][name].append(
                        event_ms(lambda: kernels.packed_scan_v3(*mixed, **kw), 10))
                del mixed
            kernels._lib = libs["base"]
            first = kernels.packed_scan_v3(*args, **kw)
            for _ in range(4):
                again = kernels.packed_scan_v3(*args, **kw)
                if not same_bits(first, again):
                    raise AssertionError(f"base K1 is not deterministic [{plane}]")
                del again
            res["shapes"][f"{plane} {tiles} tiles"] = dict(ms=times, ms_by_mix=by_mix,
                                                           base_bit_identical_runs=5)
            del args, first
            torch.cuda.empty_cache()
        res["lane_shapes"] = dict(shapes=LANE_SHAPES, ms=lane_shapes(libs))
    finally:
        kernels._lib = shipped
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/k1_ablate.json")
    ap.add_argument("--reference", default=None,
                    help="a directory holding another packed_scan_v3.cu to hold K1 "
                         "bit for bit against")
    args = ap.parse_args(argv)
    res = ablate(args.reference)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
