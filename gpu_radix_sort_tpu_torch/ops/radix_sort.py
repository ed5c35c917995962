"""Single-device sort core: full, partial and digit sorts over uint32 keys.

Port of ``gpu_radix_sort_tpu/ops/radix_sort.py``:

  * :func:`sort_full` — ascending full sort (reference: invokers.cu:45),
    int32 / float32 keys through the order-preserving codec.
  * :func:`sort_by_digits` / :func:`sort_partial` /
    :func:`sort_partial_counts` — the stable digit sort (reference:
    invokers.cu:15) with the reference's boundaries or exact counts;
    ``stable=False`` is the reference's checked contract through a rotation
    around :func:`sort_full` (sort.cu:367-394).
  * :func:`sort_key_value_by_digits` — the stable digit sort of keys with
    one 4-byte value column.

Strategies (per call, or via :func:`set_default_strategy`):
  * ``"auto"``  — the hand-written kernels.  Full sorts: n <= TILE keys in
    one block (``single_block``), larger n through ``sort_full_large``.  Digit
    sorts: n <= MAX_N_KV with width + pos_bits < 32 in one block
    (``digit_sort``), anything else through binning passes.  On a CPU tensor
    the same routes run the kernels' plain versions.
  * ``"torch"`` — ``torch.sort``, an explicit choice only.

Every entry point sorts a tensor where it lies and sends any other input
(a numpy array) to the CUDA device (:func:`ops.bits.as_tensor`).
"""

from __future__ import annotations

import torch

from . import binning, block_sort, digit_sort, merge_sort, single_block
from .bits import (
    KEY_DTYPE, as_tensor, decode_ordered, encode_ordered, rotr32,
    sortable_digits, validate_digit_range,
)
from .boundaries import compute_boundaries, digit_counts_sorted

_DEFAULT_STRATEGY = "auto"
_VALID = ("auto", "torch")


def set_default_strategy(name: str) -> None:
    global _DEFAULT_STRATEGY
    if name not in _VALID:
        raise ValueError(f"strategy must be one of {_VALID}, got {name!r}")
    _DEFAULT_STRATEGY = name


def get_default_strategy() -> str:
    return _DEFAULT_STRATEGY


def _resolve(
    strategy: str | None, n: int, kind: str = "full", width: int | None = None
) -> str:
    """The route a sort of n keys takes: "single_block" or "merge" for a full
    sort, "digit_sort" or "binning" for a stable digit sort (kind "kv") by
    ``width`` bits, or "torch"."""
    name = strategy or _DEFAULT_STRATEGY
    if name not in _VALID:
        raise ValueError(f"strategy must be one of {_VALID}, got {name!r}")
    if name == "torch":
        return "torch"
    if kind == "kv":
        return "digit_sort" if digit_sort.supported(n, width) else "binning"
    return "single_block" if n <= single_block.MAX_N else "merge"


def _sort_full_torch(keys: torch.Tensor) -> torch.Tensor:
    return encode_ordered(torch.sort(decode_ordered(keys, torch.int32)).values)


def sort_full(keys, *, strategy: str | None = None) -> torch.Tensor:
    """Ascending full sort of uint32 keys (int32 / float32 accepted through
    :func:`ops.bits.encode_ordered`; float32 in IEEE-754 totalOrder)."""
    keys = as_tensor(keys)
    if keys.dtype in (torch.int32, torch.float32):
        return decode_ordered(
            sort_full(encode_ordered(keys), strategy=strategy), keys.dtype
        )
    if keys.dtype != KEY_DTYPE:
        raise TypeError(f"unsupported key dtype {keys.dtype}; use uint32/int32/float32")
    keys = keys.contiguous()
    route = _resolve(strategy, keys.numel())
    if route == "torch":
        return _sort_full_torch(keys)
    if route == "single_block":
        return single_block.sort_single_block(keys)
    return merge_sort.sort_full_large(keys)


def _sort_by_digits_rotated(
    keys: torch.Tensor, offset: int, width: int, strategy: str | None
) -> torch.Tensor:
    """Rotate the word so the digit occupies the top bits, run a keys-only
    full sort, rotate back: digit groups in order, the multiset kept, and
    within a group the rotated-value order (a pure function of the
    values)."""
    s = (offset + width) % 32
    z = sort_full(rotr32(keys, s), strategy=strategy)
    return rotr32(z, (32 - s) % 32)


def _digit_order(keys: torch.Tensor, offset: int, width: int) -> torch.Tensor:
    """The stable digit-sort permutation by ``torch.sort`` of the narrow
    digits (``strategy="torch"``)."""
    return torch.sort(sortable_digits(keys, offset, width), stable=True).indices


def _sort_partial_torch(keys: torch.Tensor, offset: int, width: int) -> torch.Tensor:
    return keys.view(torch.int32)[_digit_order(keys, offset, width)].view(KEY_DTYPE)


def _digit_keys(keys, offset: int, width: int) -> torch.Tensor:
    validate_digit_range(offset, width)
    keys = as_tensor(keys)
    if keys.dtype != KEY_DTYPE or keys.dim() != 1:
        raise TypeError(
            f"digit sorts take 1-D uint32 keys, got {keys.dtype} "
            f"shape {tuple(keys.shape)}"
        )
    return keys.contiguous()


def sort_by_digits(
    keys, offset: int, width: int, *, strategy: str | None = None,
    stable: bool = True,
) -> torch.Tensor:
    """Sort by bits [offset, offset+width).

    ``stable=True`` (default): stable by input order within equal digits,
    the contract LSD rounds compose on.  ``stable=False``: the reference's
    checked contract only (digit groups in order, the multiset kept; within
    a group the rotated-value order) through a keys-only full sort."""
    keys = _digit_keys(keys, offset, width)
    if not stable:
        return _sort_by_digits_rotated(keys, offset, width, strategy)
    route = _resolve(strategy, keys.numel(), "kv", width)
    if route == "torch":
        return _sort_partial_torch(keys, offset, width)
    if route == "digit_sort":
        return digit_sort.sort_by_digits_small(keys, offset, width)
    return binning.sort_by_digits_large(keys, offset, width)


def sort_partial(
    keys, offset: int, width: int, *, strategy: str | None = None,
    stable: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Partial sort + reference-contract boundaries: returns
    ``(sorted_keys, boundaries)``, boundaries uint32[2^width]
    (invokers.cu:15 + sort.cu:367-394).  Boundaries do not depend on the
    order within a group, so ``stable`` does not change them."""
    sorted_keys = sort_by_digits(
        keys, offset, width, strategy=strategy, stable=stable
    )
    return sorted_keys, compute_boundaries(sorted_keys, offset, width)


def sort_partial_counts(
    keys, offset: int, width: int, *, strategy: str | None = None,
    stable: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Partial sort + exact per-digit counts (int32[2^width]), free of the
    reference boundary contract's quirks for empty groups 0 and 1."""
    sorted_keys = sort_by_digits(
        keys, offset, width, strategy=strategy, stable=stable
    )
    return sorted_keys, digit_counts_sorted(sorted_keys, offset, width)


def sort_key_value_by_digits(
    keys, values, offset: int, width: int, *, strategy: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable digit sort of (key, value) rows by bits [offset, offset+width):
    ``values`` is one column of a 4-byte type (uint32, int32, float32) that
    moves with its key.  ``"auto"`` runs binning passes that carry the
    column; ``"torch"`` a stable ``torch.sort`` of the digits and a gather.
    Wider payloads come with ROADMAP A4."""
    keys = _digit_keys(keys, offset, width)
    values = as_tensor(values)
    if values.dim() != 1 or values.dtype not in (KEY_DTYPE, torch.int32, torch.float32):
        raise NotImplementedError(
            "sort_key_value_by_digits takes one column of 4-byte values so "
            f"far; got shape {tuple(values.shape)} dtype {values.dtype} "
            "(wider payloads: ROADMAP A4)"
        )
    if values.shape[0] != keys.shape[0]:
        raise ValueError(
            f"values leading axis {values.shape[0]} != len(keys) {keys.shape[0]}"
        )
    if values.device != keys.device:
        raise ValueError(f"keys on {keys.device} but values on {values.device}")
    col = values.contiguous().view(torch.int32)
    if _resolve(strategy, keys.numel(), "kv", width) == "torch":
        order = _digit_order(keys, offset, width)
        return keys.view(torch.int32)[order].view(KEY_DTYPE), col[order].view(values.dtype)
    sk, (sv,) = binning.sort_key_value_by_digits_large(
        keys, (col.view(KEY_DTYPE),), offset, width
    )
    return sk, sv.view(torch.int32).view(values.dtype)
