"""Correctness oracles (numpy only), ported from
``gpu_radix_sort_tpu/utils/checks.py``.

  * ``check_sorted`` — monotone nondecreasing.
  * ``check_sort_full`` — exact match against ``np.sort``.
  * ``check_partial`` — exact match against the stable partial-sort oracle.
  * ``check_partial_groups`` — the reference's own partial-sort contract
    (digit groups ascending, multiset preserved), which
    ``sort_partial(..., stable=False)`` meets.
  * ``boundaries_oracle`` — the exact group-boundary contract of the
    reference's SortState::GetBoundaries (sort.cu:367-394), quirks included.
  * ``true_bucket_counts`` / ``bucket_counts_from_boundaries`` — exact
    per-digit counts, and the bucket sizes the reference derives from its
    boundaries.
"""

from __future__ import annotations

import numpy as np


def extract_digits(keys: np.ndarray, offset: int, width: int) -> np.ndarray:
    """bits [offset, offset+width) of each key (reference: sort.cu:9)."""
    if not (0 < width <= 32 and 0 <= offset and offset + width <= 32):
        raise ValueError(f"invalid digit range offset={offset} width={width}")
    mask = np.uint32(0xFFFFFFFF) if width == 32 else np.uint32((1 << width) - 1)
    return (keys.astype(np.uint32) >> np.uint32(offset)) & mask


def check_sorted(keys: np.ndarray) -> bool:
    """Monotone nondecreasing."""
    keys = np.asarray(keys)
    return bool(np.all(keys[:-1] <= keys[1:])) if keys.size > 1 else True


def check_sort_full(result: np.ndarray, original: np.ndarray) -> bool:
    """Exact bitwise match against the CPU oracle sort."""
    result = np.asarray(result, dtype=np.uint32)
    expected = np.sort(np.asarray(original, dtype=np.uint32))
    return result.shape == expected.shape and bool(np.array_equal(result, expected))


def partial_sort_oracle(
    original: np.ndarray, offset: int, width: int
) -> np.ndarray:
    """Expected output of a stable partial sort by bits
    [offset, offset+width).  The digits are cast to the narrowest unsigned
    type first, so that numpy's stable argsort takes its radix path (seconds
    at 256Mi keys, where the timsort of uint32 takes tens of seconds); the
    order is the same."""
    original = np.asarray(original, dtype=np.uint32)
    digits = extract_digits(original, offset, width)
    if width <= 8:
        digits = digits.astype(np.uint8)
    elif width <= 16:
        digits = digits.astype(np.uint16)
    return original[np.argsort(digits, kind="stable")]


def check_partial(
    result: np.ndarray, original: np.ndarray, offset: int, width: int
) -> bool:
    """Exact match against the stable partial-sort oracle."""
    expected = partial_sort_oracle(original, offset, width)
    result = np.asarray(result, dtype=np.uint32)
    return result.shape == expected.shape and bool(np.array_equal(result, expected))


def check_partial_groups(
    result: np.ndarray, original: np.ndarray, offset: int, width: int
) -> bool:
    """Digit groups ascending with the exact group sizes, and the key
    multiset preserved: the contract of ``sort_partial(stable=False)``."""
    result = np.asarray(result, dtype=np.uint32)
    original = np.asarray(original, dtype=np.uint32)
    if result.shape != original.shape:
        return False
    counts = np.bincount(
        extract_digits(original, offset, width), minlength=1 << width
    )
    expect = np.repeat(np.arange(1 << width, dtype=np.uint32), counts)
    if not np.array_equal(extract_digits(result, offset, width), expect):
        return False
    return bool(np.array_equal(np.sort(result), np.sort(original)))


def boundaries_oracle(
    sorted_keys: np.ndarray, offset: int, width: int
) -> np.ndarray:
    """Reference-contract group boundaries for digit-sorted input:
    boundaries[g] = first index i > 0 where the digit changes to g (the
    group of element 0 is never marked), then an empty-group backfill from
    high to low for groups > 1, seeded with len(keys); a zero
    boundaries[1] is never backfilled."""
    sorted_keys = np.asarray(sorted_keys, dtype=np.uint32)
    b = np.zeros(1 << width, dtype=np.uint32)
    if sorted_keys.size:
        d = extract_digits(sorted_keys, offset, width)
        change = np.nonzero(d[1:] != d[:-1])[0] + 1
        b[d[change]] = change.astype(np.uint32)
    prev = np.uint32(sorted_keys.size)
    for g in range((1 << width) - 1, 1, -1):
        if b[g] == 0:
            b[g] = prev
        prev = b[g]
    return b


def true_bucket_counts(keys: np.ndarray, offset: int, width: int) -> np.ndarray:
    """Exact per-digit counts (histogram)."""
    d = extract_digits(np.asarray(keys, dtype=np.uint32), offset, width)
    return np.bincount(d, minlength=1 << width).astype(np.int64)


def bucket_counts_from_boundaries(boundaries: np.ndarray, n: int) -> np.ndarray:
    """Bucket sizes the reference derives from boundaries
    (benchmark/pkg/sort/distrib.go:45-53): sizes[i] = b[i+1] - b[i], the
    last n - b[last]."""
    b = np.asarray(boundaries, dtype=np.int64)
    sizes = np.empty_like(b)
    sizes[:-1] = b[1:] - b[:-1]
    sizes[-1] = n - b[-1]
    return sizes
