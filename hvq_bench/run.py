"""The benchmark's command: one run of one cell on the card.

    python3 hvq_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the check compared with
its limit, which also close standard error. Exits non-zero with no result
without a CUDA card, with fewer cards than the cell asks for, or when a
JAX module or a module the benchmark must not load is loaded once the
window has closed.

Before CUDA is initialised the process is shown the cell's cards alone:
the first ``chips`` of those visible, or of an existing
``CUDA_VISIBLE_DEVICES`` list (``cards.select``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# a library the port uses must not load JAX by itself
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")

# top-level module names that may not be loaded in a run, and module
# prefixes of the port that the benchmark does not use
BANNED_TOP = ("jax", "jaxlib", "flax", "hvq_tpu", "chip_smoke", "bench", "experiments")
BANNED_PREFIX = ("hvq_tpu_torch.tools",)


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is banned as a whole word, or that lie under a banned prefix."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in BANNED_TOP
                  or any(name == p or name.startswith(p + ".") for p in BANNED_PREFIX))


def card_line(visible: str) -> str:
    """``nvidia-smi``'s name and power limit of each card that ``visible``
    lists (by index or UUID), joined by "; ", or ""."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,uuid,name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    wanted = set(visible.split(","))
    lines = [[f.strip() for f in line.split(",")] for line in out.stdout.splitlines()]
    return "; ".join(", ".join(f[2:]) for f in lines
                     if len(f) >= 4 and (f[0] in wanted or f[1] in wanted))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from hvq_bench import cards, spec

    cell = spec.cell(args.workload)
    listed = os.environ.get(cards.ENV)
    if not cards.restrict(cell.chips):
        print(f"{cell.name} asks for {cell.chips} cards, {cards.ENV}={listed!r} lists fewer",
              file=sys.stderr)
        return 2
    visible = os.environ[cards.ENV]
    print(f"cards: {cards.ENV}={visible} (was {listed!r})", file=sys.stderr)

    import torch

    from hvq_bench import harness, stats

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    traced = bool(args.trace)
    out = harness.run(cell, args.seed, args.seconds, traced, device="cuda",
                      t_start=T_START)
    found = banned_modules()
    if found:
        print(f"modules the benchmark may not load are loaded: {found}", file=sys.stderr)
        return 3
    rec = out["record"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": harness.metrics(cell, rec, traced),
              "device": device}
    if traced:
        prof = rec["profile"]
        # averaged over the cell's cards; the union over them stays in the record
        by_card = prof["busy_s_by_card"]
        device.update(busy_s=sum(by_card) / len(by_card), window_s=prof["window_s"])
        result["breakdown"] = {
            "device_ops": [[name, s] for name, s in prof["device_ops"][:10]],
            "idle_gaps": [[name, s] for name, s in prof["idle_gaps"][:10]],
        }
    chk = out["check"]
    walls = rec["walls_s"]
    half = len(walls) // 2
    print(json.dumps({
        "cell": cell.name, "seed": args.seed, "card": card_line(visible),
        "visible_cards": torch.cuda.device_count(),
        "memory_peak_bytes_by_card": rec["memory_peak_bytes_by_card"],
        "busy_s_by_card": rec["profile"]["busy_s_by_card"] if traced else None,
        "busy_s_union": rec["profile"]["busy_s"] if traced else None,
        "calls": rec["calls"],
        "file_p50_ms": {f: 1e3 * stats.percentile([w for w, g in zip(walls, rec["files"]) if g == f],
                                                  0.5) for f in sorted(set(rec["files"]))},
        "window_s": rec["window_s"], "setup_marks": rec["marks"],
        "wall_ms": {f"p{int(100 * p)}": 1e3 * stats.percentile(walls, p)
                    for p in (0.1, 0.25, 0.5, 0.75, 0.9, 0.99)} if walls else {},
        "halves_p50_ms": [1e3 * stats.percentile(w, 0.5) for w in (walls[:half], walls[half:])
                          if w],
        "judged": chk["judged"], "reruns_judged": chk["reruns_judged"],
        "last_route": rec["last_route"]}, default=str), file=sys.stderr)
    for name, (value, limit) in chk["numbers"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, (value, limit) in chk["numbers"].items()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
