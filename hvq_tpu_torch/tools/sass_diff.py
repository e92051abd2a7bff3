"""Whether two source trees compile the engines' kernels to the same SASS.

    python -m hvq_tpu_torch.tools.sass_diff --reference DIR [--out chiprun_out/sass_diff.json]

Compiles the engines' library sources (``ops/kernels.py``'s ``_SOURCES``:
K1's ``packed_scan_v3.cu``, K3/K2/K4's ``lane_scan.cu``, the level-2
select's ``level2_select.cu``, with the headers beside them) from this tree and from DIR, another tree's
``hvq_tpu_torch/csrc`` (e.g. an earlier commit's, unpacked with ``git
archive``), with the library's own nvcc flags; dumps each object with
``cuobjdump -sass``; and compares the kernels one by one, instruction for
instruction. Names are demangled (``cu++filt``) and the trailing template
arguments that a default fills, which an older tree's name lacks, are
dropped before matching: the shared body ``scan_wgmma``'s key policy
``PackedKey`` and, before it, ``kStop`` = ``kFull`` (5), what K1, K3 and K2
instantiate; so is the CUDA-core lane kernel's ``RR`` = 0 of an older tree,
whose register-list variants (RR > 0, K4's) are gone. Prints and writes one
JSON object: each kernel ``same``, ``differs``, ``only here`` or ``only in
reference``, and the count of each. Needs nvcc and cuobjdump.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from hvq_tpu_torch.ops import kernels

_FULL_STAGE = "5"          # csrc/scan_wgmma.cuh: Stage kFull
_DEFAULT_KEY = "PackedKey"  # csrc/scan_wgmma.cuh: scan_wgmma's default Key


def compile_tree(nvcc: str, tree: Path, work: Path) -> list[Path]:
    """Each engine source of ``tree`` to an object in ``work``, all at
    once (a source an older tree lacks is skipped: its kernels read as
    "only here")."""
    work.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in kernels._SOURCES:
        if not (tree / src.name).exists():
            continue
        obj = work / f"{src.stem}.o"
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-c", "-o", str(obj), str(tree / src.name)]
        jobs.append((obj, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    for obj, cmd, proc in jobs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
    return [obj for obj, _, _ in jobs]


def kernels_sass(cuobjdump: str, obj: Path) -> dict:
    """Mangled kernel name → its SASS lines."""
    out = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True, text=True,
                         check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None and line.strip().startswith("/*"):
            cur.append(line.strip())
    return funcs


def demangle(tool: str, names: list) -> dict:
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out))


def normalized(name: str) -> str:
    """The demangled name with scan_wgmma's trailing Key = PackedKey and
    then kStop = kFull dropped (``void <unnamed>::scan_wgmma<<unnamed>::Axis1,
    (int)1, …, (int)5, <unnamed>::PackedKey>(…)``), and lane_scan_kernel's
    RR = 0 (``lane_scan_kernel<(int)0, (int)0>``)."""
    m = re.search(r"scan_wgmma<(.*)>\(", name)
    if m:
        args = m.group(1).split(", ")
        if len(args) == 8 and args[-1].endswith(_DEFAULT_KEY):
            args = args[:-1]
        if len(args) == 7 and args[-1].replace("(int)", "") == _FULL_STAGE:
            args = args[:-1]
        name = name[:m.start(1)] + ", ".join(args) + name[m.end(1):]
    return re.sub(r"lane_scan_kernel<(\(int\)\d+), \(int\)0>\(", r"lane_scan_kernel<\1>(", name)


def sass_diff(reference: str) -> dict:
    nvcc = kernels.nvcc_path()
    bin_dir = Path(nvcc).parent
    cuobjdump = shutil.which("cuobjdump") or str(bin_dir / "cuobjdump")
    filt = shutil.which("cu++filt") or str(bin_dir / "cu++filt")
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as tmp:
        tmp = Path(tmp)
        ref = tmp / "reference"
        ref.mkdir()
        for f in Path(reference).iterdir():
            if f.suffix in (".cu", ".cuh"):
                shutil.copyfile(f, ref / f.name)
        sides = {}
        for side, tree in (("here", kernels._SOURCES[0].parent), ("reference", ref)):
            funcs = {}
            for obj in compile_tree(nvcc, tree, tmp / f"obj_{side}"):
                funcs.update(kernels_sass(cuobjdump, obj))
            names = demangle(filt, list(funcs))
            sides[side] = {normalized(names[k]): v for k, v in funcs.items()}
    here, there = sides["here"], sides["reference"]
    verdict = {}
    for name in sorted(set(here) | set(there)):
        if name not in there:
            verdict[name] = "only here"
        elif name not in here:
            verdict[name] = "only in reference"
        else:
            verdict[name] = "same" if here[name] == there[name] else "differs"
    counts = {v: list(verdict.values()).count(v) for v in sorted(set(verdict.values()))}
    return dict(kernels=verdict, counts=counts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", required=True,
                    help="a directory holding another tree's packed_scan_v3.cu, "
                         "lane_scan.cu and headers")
    ap.add_argument("--out", default="chiprun_out/sass_diff.json")
    args = ap.parse_args(argv)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = sass_diff(args.reference)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(dict(counts=res["counts"], kernels=res["kernels"])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
