"""The cell's own cards: which a run may see, and the fences and memory
readings that cover each of them.

A run sees exactly the first ``chips`` cards, of those visible or of an
existing ``CUDA_VISIBLE_DEVICES`` list kept in its order, so an engine that
takes every visible card (a mesh engine given ``device="cuda"``) runs on
the cell's cards and no others. The list must be set before CUDA is
initialised: the driver reads it once, at its first use in the process.
"""

from __future__ import annotations

import os

import torch

ENV = "CUDA_VISIBLE_DEVICES"


def select(chips: int, visible: str | None) -> str | None:
    """The ``CUDA_VISIBLE_DEVICES`` value that shows a cell of ``chips``
    cards: the first ``chips`` entries of ``visible`` (a comma-separated
    list of indices or UUIDs, kept in its order), or the indices
    0 … chips − 1 where no list is set. None where the list holds fewer
    than ``chips`` entries."""
    if chips < 1:
        raise ValueError(f"a cell of {chips} cards")
    if visible is None:
        return ",".join(str(i) for i in range(chips))
    entries = [e.strip() for e in visible.split(",") if e.strip()]
    if len(entries) < chips:
        return None
    return ",".join(entries[:chips])


def restrict(chips: int) -> bool:
    """Set this process's ``CUDA_VISIBLE_DEVICES`` to the cell's cards;
    False, and the environment unchanged, where fewer are listed."""
    value = select(chips, os.environ.get(ENV))
    if value is None:
        return False
    os.environ[ENV] = value
    return True


def of(device, chips: int) -> list:
    """The cell's cards as torch devices, ``cuda:0`` … ``cuda:chips−1`` of
    those visible, with CUDA initialised (the memory statistics of a card
    take no index before); none on another device type."""
    if torch.device(device).type != "cuda":
        return []
    count = torch.cuda.device_count()
    if count < chips:
        raise RuntimeError(f"the cell asks for {chips} cards, {count} visible")
    torch.cuda.init()
    return [torch.device("cuda", i) for i in range(chips)]


def synchronize(cards) -> None:
    """Wait for all the work enqueued on each card."""
    for card in cards:
        torch.cuda.synchronize(card)


def reset_peaks(cards) -> None:
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)


def peaks(cards) -> list:
    """Each card's peak allocation since its reset, in bytes."""
    return [int(torch.cuda.max_memory_allocated(card)) for card in cards]
