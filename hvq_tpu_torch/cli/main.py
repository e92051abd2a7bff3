"""Command-line entry point of the port: ``run`` (the src/test.cpp:20-112
analogue).

    python -m hvq_tpu_torch.cli run --data D.bin --queries Q.bin \\
        --engine partitioned --output output.bin --device cuda

reads the contest binary files, runs an engine (batched, partitioned or
oracle) on the named device, and
writes ``output.bin`` (headerless uint32 ids) and ``output.bin.dist``
(distances recomputed from the ids) through the port's
``hvq_tpu_torch.utils.formats``, whose files are byte-identical to the JAX
package's. Generating data and comparing ``.dist`` files stay with
``python -m hvq_tpu.cli gen-data | gen-queries | compare``.

Exit codes: 0 = ok, 1 = usage error.
"""

from __future__ import annotations

import argparse
import sys
import time


def _cmd_run(args) -> int:
    from hvq_tpu_torch.utils import formats
    from hvq_tpu_torch.models.registry import get_engine
    from hvq_tpu_torch.utils.timing import PhaseTimer

    timer = PhaseTimer(device=args.device)
    with timer.phase("read_data"):
        ds = formats.read_data_bin(args.data)
        qs = formats.read_query_bin(args.queries)
    print(f"# data points:  {ds.n}", file=sys.stderr)
    print(f"# queries:      {qs.m}", file=sys.stderr)

    kwargs = dict(device=args.device)
    if args.engine in ("batched", "partitioned"):
        for key in ("db_tile", "query_batch", "scan_store"):
            if getattr(args, key) is not None:
                kwargs[key] = getattr(args, key)
    with timer.phase("build_engine"):
        engine = get_engine(args.engine)(ds, **kwargs)
    t0 = time.perf_counter()
    ids, _ = engine.search(qs, k=args.k, sample_proportion=args.sample_proportion)
    wall = time.perf_counter() - t0
    timer.add("search", wall)
    with timer.phase("write_results"):
        formats.save_knn(ids, args.output)
        if args.save_dist:
            formats.save_knn_dist(ds, qs, ids, args.output + ".dist")
    timer.report()
    print(
        f"search: {wall:.3f} s  ({qs.m / wall:.1f} QPS, "
        f"{wall / qs.m * 1e3:.3f} ms/query) on {args.device}",
        file=sys.stderr,
    )
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hvq_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="run hybrid k-NN queries (test.cpp analogue)")
    r.add_argument("--data", required=True)
    r.add_argument("--queries", required=True)
    r.add_argument("--output", default="output.bin")
    r.add_argument("--engine", default="batched", choices=("batched", "partitioned", "oracle"))
    r.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels) or cpu")
    r.add_argument("--k", type=int, default=100)
    r.add_argument("--sample-proportion", type=float, default=1.0)
    # None → the engine's own default
    r.add_argument("--db-tile", type=int, default=None)
    r.add_argument("--query-batch", type=int, default=None)
    r.add_argument("--scan-store", default=None, choices=("fp32", "bf16"))
    r.add_argument("--save-dist", action=argparse.BooleanOptionalAction,
                   default=True, help="also write <output>.dist")
    r.set_defaults(fn=_cmd_run)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
