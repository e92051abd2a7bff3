"""The SIGMOD Programming Contest 2024 database (``src/write_data.c``, with
the contest's discretized C, README.md:29): ``C`` one of the
configuration's category levels, ``T`` ~ U[T.low, T.high], each of the
``dim`` vector dimensions ~ U[V.low, V.high], all float32.

Drawn on the device from the seed with one ``torch.Generator``, in a few
large calls: the same seed gives the same rows on any run.
"""

from __future__ import annotations

import torch

from hvq_bench.traffic import category_levels, stream_seed


def database(cfg: dict, seed: int, device) -> tuple[torch.Tensor, ...]:
    """(C (n,), T (n,), V (n, dim)) float32 on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 0))
    n, dim = int(cfg["rows"]), int(cfg["dim"])
    lo, hi = cfg["V"]["low"], cfg["V"]["high"]
    V = torch.rand((n, dim), generator=g, device=device).mul_(hi - lo).add_(lo)
    levels = category_levels(cfg, device)
    C = levels[torch.randint(0, levels.numel(), (n,), generator=g, device=device)]
    tlo, thi = cfg["T"]["low"], cfg["T"]["high"]
    T = torch.rand(n, generator=g, device=device).mul_(thi - tlo).add_(tlo)
    return C, T, V
