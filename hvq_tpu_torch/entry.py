"""Entry points of the port: the counterpart of the repository's
``__graft_entry__.py``.

* :func:`entry` — the batched search step and its example arguments;
* :func:`dryrun_multichip` — both mesh engines over n virtual shards of
  one device against the oracle, then the capacity leg
  (:func:`_dryrun_capacity`, D=10⁶) unless ``HVQ_DRYRUN_CAPACITY=0``.

    python -m hvq_tpu_torch.entry [--device cpu]
    python -m hvq_tpu_torch.entry multichip 8 [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def _tiny_problem(n=2048, m=32, categories=10):
    from hvq_tpu_torch.utils.generators import generate_dataset, generate_queries

    ds = generate_dataset(n, seed=0, categories=categories)
    qs = generate_queries(m, seed=1, categories=categories)
    return ds, qs


def entry(device="cuda"):
    """Return (fn, example_args): the flagship search step, one query batch
    of the batched exact engine (K1, the level-2 select, exact refinement
    and the certificate: ``BatchedEngine._search_batch``), on ``device``.
    ``fn(*example_args)`` returns device (ids int32 (32, 100), dists fp32
    (32, 100))."""
    from hvq_tpu_torch import constants as _c
    from hvq_tpu_torch.models import common
    from hvq_tpu_torch.models.batched import BatchedEngine, pack_query_block
    from hvq_tpu_torch.models.device_db import upload

    ds, qs = _tiny_problem()
    eng = BatchedEngine(ds, device=device, db_tile=512, query_batch=32, kprime=128)
    Vq, qtype, v, l, r, _ = common.pad_query_arrays(qs, eng.query_batch)
    Qblk = upload(pack_query_block(Vq.astype(np.float32), qtype, v, l, r), eng.device)

    def fn(Qblk, sn, n):
        ids, _suspect, dists = eng._search_batch(Qblk, sn, n, _c.K_DEFAULT)
        return ids, dists

    return fn, (Qblk, ds.n, ds.n)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run both mesh engines over ``n_devices`` virtual shards of
    ``device`` (CPU shards for ``"cpu"``, shards of one card otherwise)
    against the oracle: ``sharded`` on a (2, n/2) mesh when n is even (the
    query batch over "q" too), ``partitioned_sharded`` on a (1, n) mesh.
    Each must keep the 0.002 distance contract and recall 1.0. Then the
    capacity leg (:func:`_dryrun_capacity`) unless the environment sets
    ``HVQ_DRYRUN_CAPACITY=0``. Returns each engine's largest distance
    difference, and the capacity leg's result under ``"capacity"``."""
    from hvq_tpu_torch.models.oracle import search_oracle
    from hvq_tpu_torch.models.partitioned_sharded import ShardedPartitionedEngine
    from hvq_tpu_torch.models.sharded import ShardedEngine
    from hvq_tpu_torch.parallel.mesh import make_mesh

    devices = [device] * n_devices
    n_q = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_db_shards=n_devices // n_q, n_query_shards=n_q, devices=devices)
    mesh_d = make_mesh(devices=devices)
    ds, qs = _tiny_problem(n=1024, m=32)
    check = _checker(ds, qs, *search_oracle(ds, qs), "dryrun")
    out = {
        "sharded": check("sharded", *ShardedEngine(
            ds, mesh=mesh, db_tile=128, query_batch=32).search(qs)),
        "partitioned_sharded": check("partitioned_sharded", *ShardedPartitionedEngine(
            ds, mesh=mesh_d, db_tile=128, query_batch=32).search(qs)),
    }
    print(f"dryrun_multichip OK: sharded q={n_q} d={n_devices // n_q}, "
          f"partitioned_sharded d={n_devices} on {device}: recall=1.0, "
          f"max_dist_diff={out}")
    if os.environ.get("HVQ_DRYRUN_CAPACITY", "1") != "0":
        out["capacity"] = _dryrun_capacity(n_devices, device)
    return out


def _checker(ds, qs, oids, odists, what: str):
    """``check(tag, ids, dists)``: assert the 0.002 contract and recall 1.0
    against the oracle's answer; returns the largest distance difference."""
    from hvq_tpu_torch.utils.compare import compare_distances, recall_at_k
    from hvq_tpu_torch.utils.formats import recompute_result_distances

    def check(tag, ids, dists):
        res = compare_distances(
            recompute_result_distances(ds, qs, ids.astype(np.int64)),
            recompute_result_distances(ds, qs, oids.astype(np.int64)),
        )
        assert res.ok, f"{tag} {what} violates the distance contract: {res}"
        rec = recall_at_k(ids, oids, dists, odists)
        assert rec == 1.0, f"{tag} {what} recall {rec} != 1.0"
        return res.max_abs_diff

    return check


def _dryrun_capacity(n_devices: int, device="cuda", n: int = 1_000_000, m: int = 16,
                     categories: int = 100, db_tile: int = 8192,
                     window_rows: int = 262_144) -> dict:
    """The capacity leg of the dry run (the repository's
    ``__graft_entry__._dryrun_capacity``): D = ``n`` rows, each step held
    to ``search_oracle_batched`` at recall 1.0 and the 0.002 contract.

    (a) ``partitioned_sharded`` over ``n_devices`` virtual shards of
    ``device`` at ``db_tile``-row tiles: many tiles a shard (≈ 31 on 4
    shards at the defaults, ≈ 16 on 8), the shape a large shard sees, not
    the small legs' one tile; (b) the paged engine with ``window_rows``-row
    windows (4 at the defaults), the path of a database larger than the
    card. Returns each step's largest distance difference, the tiles a
    shard and the window count."""
    from hvq_tpu_torch.models.oracle import search_oracle_batched
    from hvq_tpu_torch.models.paged import PagedEngine
    from hvq_tpu_torch.models.partitioned_sharded import ShardedPartitionedEngine
    from hvq_tpu_torch.parallel.mesh import make_mesh

    ds, qs = _tiny_problem(n=n, m=m, categories=categories)
    check = _checker(ds, qs, *search_oracle_batched(ds, qs), "capacity dryrun")
    eng = ShardedPartitionedEngine(ds, mesh=make_mesh(devices=[device] * n_devices),
                                   db_tile=db_tile, query_batch=16)
    tiles_per_shard = eng._local_n // db_tile
    diff_mesh = check("capacity_mesh", *eng.search(qs))
    del eng
    eng = PagedEngine(ds, device=device, window_rows=window_rows, query_batch=16,
                      db_tile=db_tile)
    n_windows = len(eng.windows)
    diff_paged = check("capacity_paged", *eng.search(qs))
    out = dict(n=ds.n, shards=n_devices, tiles_per_shard=tiles_per_shard,
               max_dist_diff_mesh=diff_mesh, windows=n_windows,
               max_dist_diff_paged=diff_paged)
    print(f"dryrun_capacity OK: D={ds.n} over d={n_devices} shards "
          f"({tiles_per_shard} tiles/shard, max_dist_diff={diff_mesh}); paged "
          f"{n_windows} windows (max_dist_diff={diff_paged}); recall=1.0 both")
    return out


def main(argv: list[str]) -> int:
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if argv and argv[0] == "multichip":
        dryrun_multichip(int(argv[1]) if len(argv) > 1 else 8, device)
        return 0
    fn, args = entry(device)
    out = fn(*args)
    print("entry OK:", [tuple(o.shape) for o in out])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
