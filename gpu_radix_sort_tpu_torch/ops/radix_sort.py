"""Single-device sort core: full and partial sorts over uint32 keys.

Port of ``gpu_radix_sort_tpu/ops/radix_sort.py`` (slice one):

  * :func:`sort_full` — ascending full sort (reference: invokers.cu:45),
    int32 / float32 keys through the order-preserving codec.
  * :func:`sort_by_digits` / :func:`sort_partial` with ``stable=False`` —
    the reference's checked contract through a rotation around
    :func:`sort_full` (reference: invokers.cu:15 + sort.cu:367-394).

Strategies (per call, or via :func:`set_default_strategy`):
  * ``"auto"``  — the hand-written kernels: n <= TILE keys in one block
    (``block_sort``), larger n through ``sort_full_large``.  On a CPU
    tensor the same route runs the kernels' plain versions.
  * ``"torch"`` — ``torch.sort``, an explicit choice only.
"""

from __future__ import annotations

import torch

from . import block_sort, merge_sort
from .bits import (
    KEY_DTYPE, decode_ordered, encode_ordered, rotr32, validate_digit_range,
)
from .boundaries import compute_boundaries

_DEFAULT_STRATEGY = "auto"
_VALID = ("auto", "torch")


def set_default_strategy(name: str) -> None:
    global _DEFAULT_STRATEGY
    if name not in _VALID:
        raise ValueError(f"strategy must be one of {_VALID}, got {name!r}")
    _DEFAULT_STRATEGY = name


def get_default_strategy() -> str:
    return _DEFAULT_STRATEGY


def _resolve(strategy: str | None, n: int) -> str:
    """The route a full sort of n keys takes: "block_sort", "merge" or
    "torch"."""
    name = strategy or _DEFAULT_STRATEGY
    if name not in _VALID:
        raise ValueError(f"strategy must be one of {_VALID}, got {name!r}")
    if name == "torch":
        return "torch"
    return "block_sort" if n <= block_sort.TILE else "merge"


def _sort_full_torch(keys: torch.Tensor) -> torch.Tensor:
    return encode_ordered(torch.sort(decode_ordered(keys, torch.int32)).values)


def sort_full(keys, *, strategy: str | None = None) -> torch.Tensor:
    """Ascending full sort of uint32 keys (int32 / float32 accepted through
    :func:`ops.bits.encode_ordered`; float32 in IEEE-754 totalOrder)."""
    keys = torch.as_tensor(keys)
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
    if route == "block_sort":
        return block_sort.sort_single_block(keys)
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


def sort_by_digits(
    keys, offset: int, width: int, *, strategy: str | None = None,
    stable: bool = True,
) -> torch.Tensor:
    """Sort by bits [offset, offset+width).  Only ``stable=False`` (the
    reference's checked contract) is ported so far."""
    validate_digit_range(offset, width)
    if stable:
        raise NotImplementedError(
            "stable digit sorts come with the port of the digit-sort kernels "
            "B4/B5 (ROADMAP A3); pass stable=False"
        )
    keys = torch.as_tensor(keys)
    if keys.dtype != KEY_DTYPE:
        raise TypeError(f"digit sorts take uint32 keys, got {keys.dtype}")
    return _sort_by_digits_rotated(keys.contiguous(), offset, width, strategy)


def sort_partial(
    keys, offset: int, width: int, *, strategy: str | None = None,
    stable: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Partial sort + reference-contract boundaries: returns
    ``(sorted_keys, boundaries)``, boundaries uint32[2^width]."""
    sorted_keys = sort_by_digits(
        keys, offset, width, strategy=strategy, stable=stable
    )
    return sorted_keys, compute_boundaries(sorted_keys, offset, width)
