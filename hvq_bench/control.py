"""The control of the check: the plain reference put in the program's place
and computed one step of precision below what the configuration states
(TF32 operands for fp32 products), which the check must judge not correct.

    python3 hvq_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 5

Runs the cell with the control in the program's place once a seed, in one
process, each run with its window and its check as ``run.py`` runs them,
and prints one JSON line a seed: ``correct`` and each number beside its
limit (the limits' upper readings). The benchmark's own runs never run
it. Needs the card, as ``run.py`` does, and sees the cell's cards alone,
as ``run.py`` does; the tests drive the same engine on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from hvq_bench import cards, harness, reference, spec  # noqa: E402


class ControlEngine:
    """The reference at TF32 answering the timed calls: ``search`` as the
    port's engines take it."""

    def __init__(self, cfg: dict, ds, device):
        self.device = torch.device(device)
        self.V = torch.from_numpy(ds.V).to(self.device)
        self.C = torch.from_numpy(ds.C).to(self.device)
        self.T = torch.from_numpy(ds.T).to(self.device)
        self.last_ladder = {"suspects": 0}

    def search(self, qs, k: int = 100, sample_proportion: float = 1.0,
               return_dists: bool = False, phases=None):
        f = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
             for a in (qs.qtype, qs.v, qs.l, qs.r, qs.V)]
        sn = int(sample_proportion * self.V.shape[0])
        ids, d, _ = reference.search(self.V, self.C, self.T, *f, k, sn,
                                     precision="tf32")
        return (ids.cpu().numpy().astype(np.uint32),
                d.float().cpu().numpy() if return_dists else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    # before CUDA is initialised: the driver reads the list once
    if not cards.restrict(cell.chips):
        print(f"{cell.name} asks for {cell.chips} cards, fewer are listed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} asks for {cell.chips} cards, fewer are present", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run(cell, seed, args.seconds, False, device="cuda", engine=ControlEngine)
        chk = out["check"]
        print(json.dumps({
            "cell": cell.name, "engine": "control", "seed": seed,
            "correct": out["correct"], "calls": out["record"]["calls"],
            "judged": chk["judged"], "reruns_judged": chk["reruns_judged"],
            "failed": chk["failed"], "seconds": time.perf_counter() - t0,
            "checks": {n: {"value": v, "limit": lim}
                       for n, (v, lim) in chk["numbers"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
