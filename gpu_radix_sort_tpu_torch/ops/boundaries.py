"""Group-boundary detection over digit-sorted keys.

Port of ``gpu_radix_sort_tpu/ops/boundaries.py``: :func:`compute_boundaries`
is bit-exact with the reference's SortState::GetBoundaries (sort.cu:367-394),
both of its quirks included, and derived scatter-free from the true group
starts; :func:`digit_counts` and :func:`digit_counts_sorted` are the exact
per-digit counts the distributed paths use.  Digits are searched as int64
(``searchsorted`` takes no uint32).
"""

from __future__ import annotations

import torch

from ..utils.timers import span
from .bits import as_tensor, from_int64, to_int64, validate_digit_range


def _digits(sorted_keys: torch.Tensor, offset: int, width: int) -> torch.Tensor:
    return (to_int64(sorted_keys) >> offset) & ((1 << width) - 1)


def _group_starts(sorted_keys: torch.Tensor, offset: int, width: int) -> torch.Tensor:
    d = _digits(sorted_keys, offset, width)
    queries = torch.arange((1 << width) + 1, dtype=torch.int64, device=d.device)
    return torch.searchsorted(d, queries, side="left")


def true_group_starts(
    sorted_keys: torch.Tensor, offset: int, width: int
) -> torch.Tensor:
    """s[g] = first index where group g would start, for g in 0..2^width
    (s[2^width] = n), as uint32."""
    validate_digit_range(offset, width)
    sorted_keys = as_tensor(sorted_keys)
    return from_int64(_group_starts(sorted_keys, offset, width))


def compute_boundaries(
    sorted_keys: torch.Tensor, offset: int, width: int
) -> torch.Tensor:
    """Reference-contract boundaries of each digit group (uint32[2^width]).

    Input must already be sorted by bits [offset, offset+width).  As in the
    reference:

      * groups in [2, d[0]] report the start of the group after d[0]
        (element 0's group is never marked, and the backfill overwrites);
      * an empty group 1 reports 0 instead of its true start;
      * all other groups report their true start.
    """
    validate_digit_range(offset, width)
    sorted_keys = as_tensor(sorted_keys)
    nb = 1 << width
    device = sorted_keys.device
    if sorted_keys.numel() == 0:
        return from_int64(torch.zeros(nb, dtype=torch.int64, device=device))
    with span("grs.boundaries"):
        s = _group_starts(sorted_keys, offset, width)
        g = torch.arange(nb, dtype=torch.int64, device=device)
        g0 = _digits(sorted_keys[:1], offset, width)[0]
        b = torch.where((g >= 2) & (g <= g0), s[g0 + 1], s[:nb])
        group1_empty = s[2] <= s[1]
        b = torch.where((g == 1) & group1_empty, torch.zeros_like(b), b)
        return from_int64(b)


def digit_counts(keys, offset: int, width: int) -> torch.Tensor:
    """Exact per-digit counts (int32[2^width]) of keys in any order."""
    validate_digit_range(offset, width)
    d = _digits(as_tensor(keys), offset, width)
    return torch.bincount(d, minlength=1 << width).to(torch.int32)


def digit_counts_sorted(sorted_keys, offset: int, width: int) -> torch.Tensor:
    """Per-digit counts (int32[2^width]) of digit-sorted keys, from the
    differences of the group starts."""
    validate_digit_range(offset, width)
    s = _group_starts(as_tensor(sorted_keys), offset, width)
    return (s[1:] - s[:-1]).to(torch.int32)


def counts_to_boundaries(counts) -> torch.Tensor:
    """Exclusive prefix sum of the counts: the true start of each digit
    group, in the counts' dtype."""
    counts = as_tensor(counts)
    starts = torch.cumsum(counts, 0)[:-1].to(counts.dtype)
    return torch.cat([torch.zeros(1, dtype=counts.dtype, device=counts.device), starts])
