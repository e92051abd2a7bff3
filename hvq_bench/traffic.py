"""The one traffic generator: a pool of queries and the calls that take
slices of it, from a traffic file's parameters and the run's seed.

A traffic file (``workloads/<traffic>.json``) holds:

* ``call_queries``: queries in one call of ``engine.search``;
* ``pool_calls``: distinct calls in the pool, cycled in order;
* ``types``: the query types drawn, in equal counts: in every call where
  ``call_queries`` is a multiple of their number, else over the pool;
* ``l``: [low, high] of a range's lower end; ``r_max``: the upper end is
  U[l, r_max]; ``vec``: [low, high] of each query dimension; ``v`` is one
  of the configuration's category levels (``write_query.c``);
* ``warmup_calls``: whole calls from the pool's start, before the window;
* ``trace_calls`` and ``fenced_calls``: the calls of a traced run's
  profiled and fenced parts;
* ``check_queries``: the answers the check draws, the same number of each
  type; ``check_reruns``: at most this many answers of the rerun ladder
  are added to them.

Every seed gives the same type counts, so a seed changes which queries a
call holds and not how much work it is.
"""

from __future__ import annotations

import torch

KEYS = ("call_queries", "pool_calls", "types", "l", "r_max", "vec",
        "warmup_calls", "trace_calls", "fenced_calls",
        "check_queries", "check_reruns")


def stream_seed(seed: int, stream: int) -> int:
    """The generator seed of stream 0 (the database) or 1 (the queries)."""
    return (2 * int(seed) + stream) % 2 ** 63


def category_levels(cfg: dict, device) -> torch.Tensor:
    """The configuration's discretized category values, evenly spaced."""
    c = cfg["C"]
    return torch.linspace(c["low"], c["high"], c["levels"], dtype=torch.float32,
                          device=device)


def check(traffic: dict) -> None:
    missing = [k for k in KEYS if k not in traffic]
    if missing:
        raise KeyError(f"traffic file lacks {missing}")


def pool(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """Host arrays of the query pool: ``qtype`` int32, ``v``, ``l``, ``r``
    float32 (-1 where the type has no such predicate) and ``V`` (m, dim)
    float32, drawn on ``device`` from the seed and copied back once."""
    check(traffic)
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 1))
    m_call, calls = int(traffic["call_queries"]), int(traffic["pool_calls"])
    m = m_call * calls
    types = torch.tensor(traffic["types"], dtype=torch.int32, device=device)
    nt = types.numel()
    block = m_call if m_call % nt == 0 else m
    if block % nt:
        raise ValueError(f"{m} pool queries do not split evenly over types "
                         f"{traffic['types']}")
    keys = torch.rand((m // block, block), generator=g, device=device)
    qtype = types.repeat(block // nt)[keys.argsort(dim=1)].reshape(m)
    levels = category_levels(cfg, device)
    v = levels[torch.randint(0, levels.numel(), (m,), generator=g, device=device)]
    lo, hi = traffic["l"]
    l = torch.rand(m, generator=g, device=device) * (hi - lo) + lo
    r = l + (traffic["r_max"] - l) * torch.rand(m, generator=g, device=device)
    vlo, vhi = traffic["vec"]
    V = torch.rand((m, cfg["dim"]), generator=g, device=device) * (vhi - vlo) + vlo
    has_c = (qtype == 1) | (qtype == 3)
    has_t = (qtype == 2) | (qtype == 3)
    none = torch.tensor(-1.0, device=device)
    out = dict(qtype=qtype, v=torch.where(has_c, v, none),
               l=torch.where(has_t, l, none), r=torch.where(has_t, r, none), V=V)
    return {name: t.cpu().numpy() for name, t in out.items()}


def call_slice(traffic: dict, i: int) -> slice:
    """The pool rows of call ``i`` (calls cycle through the pool)."""
    m_call = int(traffic["call_queries"])
    j = i % int(traffic["pool_calls"])
    return slice(j * m_call, (j + 1) * m_call)

