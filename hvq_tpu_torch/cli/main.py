"""Command-line entry points of the port: the counterpart of ``hvq_tpu.cli``.

Subcommands:

* ``run``         — the src/test.cpp:20-112 analogue: read D and Q, run an
                    engine on ``--device`` (``cuda``, the default, or
                    ``cpu``), write ``output.bin`` (headerless uint32 ids)
                    and ``output.bin.dist`` (distances recomputed from the
                    ids). ``--engine-opt KEY=VALUE`` passes any keyword the
                    engine's constructor takes, ``--index`` loads a
                    checkpoint, ``--resilient`` wraps the engine in
                    retry + OOM bisection, ``--profile DIR`` writes a
                    ``torch.profiler`` Chrome trace of the search;
                    ``--engine sharded`` and ``partitioned_sharded`` run
                    on the default mesh of ``--device`` (every visible
                    card, or one CPU shard);
* ``compare``     — the src/compare_data.cpp:80-108 analogue: pairwise
                    element-wise diff of ``<path>.dist`` files under the
                    0.002 tolerance;
* ``build-index`` — build and checkpoint a partitioned or IVF index on
                    ``--device``;
* ``gen-data``    — src/write_data.c analogue;
* ``gen-queries`` — src/write_query.c analogue.

Every file goes through the port's ``utils/formats``, byte-identical to the
JAX package's for the same arguments. The JAX CLI's ``--platform`` and
``--cache-dir`` have no counterpart here (``--device`` takes their
place), and its host hardware counters around the search
(``hvq_tpu.native.PerfCounters``) are not ported yet.

Exit codes: 0 = ok/similar, 1 = usage error, 2 = comparison found
differences beyond tolerance.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import sys
import time

from hvq_tpu_torch.models.registry import available_engines


def _engine_opts(opts, accepted, engine: str) -> dict:
    """``KEY=VALUE`` strings → keywords the engine takes (int, float or
    str, in that order); keys it does not take are dropped with a
    warning."""
    kwargs = {}
    for opt in opts or ():
        key, _, val = opt.partition("=")
        if key not in accepted:
            print(f"warning: {engine} ignores --engine-opt {key}", file=sys.stderr)
            continue
        for conv in (int, float, str):
            try:
                kwargs[key] = conv(val)
                break
            except ValueError:
                continue
    return kwargs


def _cmd_run(args) -> int:
    from hvq_tpu_torch.models.device_db import resolve_device
    from hvq_tpu_torch.models.registry import get_engine
    from hvq_tpu_torch.utils import formats
    from hvq_tpu_torch.utils.timing import PhaseTimer

    timer = PhaseTimer(device=resolve_device(args.device))
    with timer.phase("read_data"):
        ds = formats.read_data_bin(args.data)
        qs = formats.read_query_bin(args.queries)
    print(f"# data points:  {ds.n}", file=sys.stderr)
    print(f"# queries:      {qs.m}", file=sys.stderr)

    engine_cls = get_engine(args.engine)
    accepted = inspect.signature(engine_cls.__init__).parameters
    kwargs = {
        k: v
        for k, v in dict(db_tile=args.db_tile, query_batch=args.query_batch,
                         precision=args.precision, scan_store=args.scan_store).items()
        if k in accepted and v is not None
    }
    kwargs.update(_engine_opts(args.engine_opt, accepted, args.engine))
    kwargs["device"] = args.device
    if args.index:
        from hvq_tpu_torch.index.serialize import load_index

        with timer.phase("load_index"):
            kwargs["index"] = load_index(args.index, device=args.device)
    with timer.phase("build_engine"):
        engine = engine_cls(ds, **kwargs)
    if args.resilient:
        from hvq_tpu_torch.utils.resilience import ResilientEngine

        engine = ResilientEngine(engine)

    # timed region = ids only, as the reference's vec_query; the .dist file
    # is recomputed from the ids afterwards (src/test.cpp:95-110)
    search_params = inspect.signature(getattr(engine, "engine", engine).search).parameters
    search_kw = {"return_dists": False} if "return_dists" in search_params else {}
    if args.profile:
        from hvq_tpu_torch.utils.profiling import trace

        profiler = trace(args.profile)
    else:
        profiler = contextlib.nullcontext()
    with profiler:
        t0 = time.perf_counter()
        ids, _ = engine.search(qs, k=args.k, sample_proportion=args.sample_proportion,
                               **search_kw)
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


def _cmd_compare(args) -> int:
    import numpy as np

    from hvq_tpu_torch.utils import formats
    from hvq_tpu_torch.utils.compare import compare_distances

    paths = [p if p.endswith(".dist") else p + ".dist" for p in args.files]
    worst = "same"
    rank = {"same": 0, "similar": 1, "different": 2}
    for i in range(len(paths)):
        for j in range(i + 1, len(paths)):
            a = formats.read_dist(paths[i])
            b = formats.read_dist(paths[j])
            res = compare_distances(a, b, tolerance=args.tolerance)
            print(
                f"{paths[i]} vs {paths[j]}: {res.status} "
                f"(max |Δ| = {res.max_abs_diff:.6g}, "
                f"{res.num_exceeding}/{res.total} beyond {args.tolerance})"
            )
            if res.status == "different" and args.show_diffs:
                # the first offending entries, as compare.out prints them
                # (reference src/compare_data.cpp:44-58 prints up to 50)
                bad = np.argwhere(np.abs(a - b) > args.tolerance)
                for qi, ki in bad[: args.show_diffs]:
                    print(
                        f"  query {qi} rank {ki}: "
                        f"{a[qi, ki]:.6f} vs {b[qi, ki]:.6f} "
                        f"(Δ = {a[qi, ki] - b[qi, ki]:+.6f})"
                    )
            if rank[res.status] > rank[worst]:
                worst = res.status
    return 2 if worst == "different" else 0


def _cmd_build_index(args) -> int:
    from hvq_tpu_torch.index import serialize
    from hvq_tpu_torch.models.device_db import resolve_device
    from hvq_tpu_torch.utils import formats
    from hvq_tpu_torch.utils.timing import PhaseTimer

    timer = PhaseTimer(device=resolve_device(args.device))
    with timer.phase("read_data"):
        ds = formats.read_data_bin(args.data)
    with timer.phase("build"):
        if args.kind == "partitioned":
            from hvq_tpu_torch.index.partition import PartitionedIndex

            idx = PartitionedIndex.build(ds, db_tile=args.db_tile, device=args.device)
            serialize.save_partitioned(idx, args.out)
        else:
            from hvq_tpu_torch.index.ivf import IVFIndex

            idx = IVFIndex.build(ds, cap=args.cap, iters=args.kmeans_iters,
                                 seed=args.seed, device=args.device)
            serialize.save_ivf(idx, args.out)
    timer.report()
    print(f"wrote {args.kind} index to {args.out}", file=sys.stderr)
    return 0


def _cmd_gen_data(args) -> int:
    from hvq_tpu_torch.utils import formats
    from hvq_tpu_torch.utils.generators import generate_dataset

    ds = generate_dataset(args.n, seed=args.seed, categories=args.categories)
    formats.write_data_bin(args.path, ds)
    print(f"wrote {args.n} records to {args.path}", file=sys.stderr)
    return 0


def _cmd_gen_queries(args) -> int:
    from hvq_tpu_torch.utils import formats
    from hvq_tpu_torch.utils.generators import generate_queries

    qs = generate_queries(args.m, seed=args.seed, categories=args.categories)
    formats.write_query_bin(args.path, qs)
    print(f"wrote {args.m} queries to {args.path}", file=sys.stderr)
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
    r.add_argument("--engine", default="batched", choices=available_engines())
    r.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels) or cpu; the mesh "
                        "engines (sharded, partitioned_sharded) put every "
                        "visible card, or one CPU shard, on their mesh")
    r.add_argument("--k", type=int, default=100)
    r.add_argument("--sample-proportion", type=float, default=1.0)
    # None → the engine's own default
    r.add_argument("--db-tile", type=int, default=None)
    r.add_argument("--query-batch", type=int, default=None)
    r.add_argument("--precision", default=None, choices=("highest", "high", "default"))
    r.add_argument("--scan-store", default=None, choices=("fp32", "bf16"))
    r.add_argument("--engine-opt", action="append", metavar="KEY=VALUE",
                   help="extra engine keywords (e.g. nprobe=32, window_rows=4096)")
    r.add_argument("--resilient", action="store_true",
                   help="wrap the engine with retry + OOM bisection")
    r.add_argument("--index", help="prebuilt index checkpoint (.npz) to load")
    r.add_argument("--save-dist", action=argparse.BooleanOptionalAction,
                   default=True, help="also write <output>.dist")
    r.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the search into DIR")
    r.set_defaults(fn=_cmd_run)

    c = sub.add_parser("compare",
                       help="pairwise-diff .dist files (compare_data.cpp analogue)")
    c.add_argument("files", nargs="+")
    c.add_argument("--tolerance", type=float, default=0.002)
    c.add_argument("--show-diffs", type=int, default=50, metavar="N",
                   help="print up to N offending entries (0 = none)")
    c.set_defaults(fn=_cmd_compare)

    bi = sub.add_parser("build-index",
                        help="build + checkpoint an index (partitioned/ivf)")
    bi.add_argument("--data", required=True)
    bi.add_argument("--kind", required=True, choices=("partitioned", "ivf"))
    bi.add_argument("--out", required=True)
    bi.add_argument("--device", default="cuda",
                    help="torch device: cuda or cpu")
    bi.add_argument("--db-tile", type=int, default=8192)
    bi.add_argument("--cap", type=int, default=1024)
    bi.add_argument("--kmeans-iters", type=int, default=8)
    bi.add_argument("--seed", type=int, default=0)
    bi.set_defaults(fn=_cmd_build_index)

    gd = sub.add_parser("gen-data", help="synthetic dataset (write_data.c analogue)")
    gd.add_argument("path")
    gd.add_argument("n", type=int)
    gd.add_argument("--seed", type=int, default=0)
    gd.add_argument("--categories", type=int, default=None)
    gd.set_defaults(fn=_cmd_gen_data)

    gq = sub.add_parser("gen-queries", help="synthetic queries (write_query.c analogue)")
    gq.add_argument("path")
    gq.add_argument("m", type=int)
    gq.add_argument("--seed", type=int, default=1)
    gq.add_argument("--categories", type=int, default=None)
    gq.set_defaults(fn=_cmd_gen_queries)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
