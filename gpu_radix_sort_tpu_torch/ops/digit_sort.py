"""Stable digit sort of a few keys in one block: the wrapper of
``digit_sort_kernel`` in ``csrc/block_sort.cu``.

Replaces ``gpu_radix_sort_tpu/ops/pallas_sort.py:185`` ``_sort_kv_kernel``
(B4, with ``pallas_sort.sort_by_digits``): a bitonic network over the unique
composites ``digit << pos_bits | i``, carrying the key, is a stable sort by
digit.  The network holds the composite and the key, 8 bytes a slot, so one
block of this card's 227 KB of shared memory takes MAX_N_KV = 2^14 keys
(128 KB), not the TPU's 2^16.  ``pos_bits`` is log2 of the next power of
two of n, and ``width + pos_bits < 32`` keeps every composite below the
0xFFFFFFFF pads; wider windows take the binning passes.

On a CPU tensor :func:`sort_by_digits_small` runs
:func:`sort_by_digits_small_plain`, a stable ``torch.sort`` of the digits and
a gather; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .bits import KEY_BITS, sortable_digits, validate_digit_range
from .block_sort import check_keys

MAX_N_KV = 1 << 14  # keys one block sorts (2 x 4 bytes a key, 128 KB)

launches = 0  # kernel launches, for showing that a run went through the kernel


def pos_bits(n: int) -> int:
    """Bits of the position in the composite: log2 of next_pow2(n)."""
    return max(n - 1, 0).bit_length()


def supported(n: int, width: int) -> bool:
    """Whether one block sorts n keys by a window of ``width`` bits."""
    return 0 < n <= MAX_N_KV and width + pos_bits(n) < KEY_BITS


def sort_by_digits_small_plain(
    keys: torch.Tensor, offset: int, width: int
) -> torch.Tensor:
    """Plain PyTorch version: a stable sort of the digits, then a gather."""
    order = torch.sort(sortable_digits(keys, offset, width), stable=True).indices
    return keys.view(torch.int32)[order].view(torch.uint32)


def sort_by_digits_small(
    keys: torch.Tensor, offset: int, width: int
) -> torch.Tensor:
    """Stable sort of n <= MAX_N_KV uint32 keys by bits [offset,
    offset+width), with width + pos_bits(n) < 32.  Returns a new tensor."""
    global launches
    check_keys(keys)
    validate_digit_range(offset, width)
    n = keys.numel()
    if not supported(n, width):
        raise ValueError(
            f"one block sorts n in [1, {MAX_N_KV}] keys with width + "
            f"{pos_bits(n)} position bits < 32; got n={n}, width={width}"
        )
    if keys.device.type == "cpu":
        return sort_by_digits_small_plain(keys, offset, width)
    out = torch.empty_like(keys)
    lib = build.load()
    with torch.cuda.device(keys.device):
        status = lib.grs_digit_sort_u32(
            keys.data_ptr(), out.data_ptr(), n, offset, width,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "digit_sort launch")
    launches += 1
    return out
