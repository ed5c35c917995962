"""Plain references for the cells' comparisons, in PyTorch and numpy alone.

Nothing here imports the port or the JAX package, and nothing takes a table,
a buffer or a result that the port made: every function works from keys
that the benchmark made (``keys.py``).  PyTorch sorts no uint32 on the card,
so the keys are sorted as their order-preserving int32 image
(``x ^ 0x8000_0000``).

The controls at the end are the same references one step below what the
configurations state: keys ordered by their float32 value, which keeps 24
of the 32 bits, so keys that differ only in their low bits keep their input
order.  A comparison that lets such a sort pass cannot hold the exact order.
"""

from __future__ import annotations

import numpy as np
import torch

_SIGN = -(1 << 31)


def _ordered(keys: torch.Tensor) -> torch.Tensor:
    """uint32 keys as int32 values in the same order."""
    return keys.view(torch.int32) ^ _SIGN


def _unordered(x: torch.Tensor) -> torch.Tensor:
    return (x ^ _SIGN).view(torch.uint32)


def sort_full(keys: torch.Tensor) -> torch.Tensor:
    """The keys in ascending order."""
    return _unordered(torch.sort(_ordered(keys)).values)


def digits(keys: torch.Tensor, offset: int, width: int) -> torch.Tensor:
    """Bits [offset, offset + width) of each key, as int32."""
    return (keys.view(torch.int32) >> offset) & ((1 << width) - 1)


def sort_by_digit(keys: torch.Tensor, offset: int, width: int):
    """The stable sort by one digit: (keys, counts of each digit), keys
    with equal digits in their input order."""
    d = digits(keys, offset, width)
    order = torch.sort(d, stable=True).indices
    counts = torch.bincount(d, minlength=1 << width)
    return keys.view(torch.int32)[order].view(torch.uint32), counts


def boundaries(counts, n: int) -> np.ndarray:
    """The upstream's group boundaries (SortState::GetBoundaries,
    libsort/sort.cu:367-394) of digit-sorted keys with these counts.

    Transcribed from its two steps.  ``gpu_groups`` marks, at each index i
    > 0 where the digit changes, b[digit] = i: the group of element 0 is
    never marked.  The host then walks the groups from the top down to
    group 2 and gives each unmarked one the value above it (n above the
    top): group 1 is never filled, and group 0 stays 0."""
    counts = np.asarray(counts, dtype=np.int64)
    nb = counts.size
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    first = int(np.flatnonzero(counts)[0]) if n else -1
    b = np.zeros(nb, dtype=np.int64)
    for g in range(nb):
        if counts[g] and g != first:
            b[g] = starts[g]
    for g in range(nb - 1, 1, -1):
        if b[g] == 0:
            b[g] = b[g + 1] if g + 1 < nb else n
    return b


def sort_shards(shards: list[torch.Tensor], device) -> list[torch.Tensor]:
    """The mesh sort's result: every shard's keys sorted together on
    ``device``, cut back into shards of the input's sizes."""
    flat = sort_full(torch.cat([s.to(device) for s in shards]))
    return list(torch.split(flat, [s.numel() for s in shards]))


def sort_full_float32(keys: torch.Tensor) -> torch.Tensor:
    """Control: the keys ordered by their float32 value, stably."""
    value = (keys.view(torch.int32).to(torch.int64) & 0xFFFFFFFF).to(torch.float32)
    order = torch.sort(value, stable=True).indices
    return keys.view(torch.int32)[order].view(torch.uint32)


def sort_shards_float32(shards: list[torch.Tensor], device) -> list[torch.Tensor]:
    """Control of :func:`sort_shards`: the float32 order over every shard."""
    flat = sort_full_float32(torch.cat([s.to(device) for s in shards]))
    return list(torch.split(flat, [s.numel() for s in shards]))


def mismatches(out, want: torch.Tensor) -> int:
    """Positions at which ``out`` differs from ``want``; every position
    where ``out`` is no tensor of ``want``'s size."""
    if not isinstance(out, torch.Tensor) or out.numel() != want.numel():
        return want.numel()
    out = out.reshape(-1).to(want.device)
    return int((out.view(torch.int32) != want.view(torch.int32)).sum())
