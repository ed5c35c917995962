"""Stable digit sort of a few keys in one block: the wrapper of
``digit_sort_kernel`` in ``csrc/block_sort.cu``.

Replaces ``gpu_radix_sort_tpu/ops/pallas_sort.py:185`` ``_sort_kv_kernel``
(B4, with ``pallas_sort.sort_by_digits``), which sorted the unique
composites ``digit << pos_bits | i`` with a bitonic network carrying the
key.  The kernel here runs LSD counting passes of 8 bits or fewer
(``csrc/block_rank.cuh``): 1024 threads hold up to 16 keys each in
registers, rank them by digit with warp ballots and per-(digit, warp)
counters, and scatter them into shared memory.  One block takes MAX_N_KV =
2^14 keys (64 KB of sorted slots and 33 KB of counters at 8 bits), not the
TPU's 2^16.

The kernel takes any width; :func:`supported` still routes only
``width + pos_bits(n) < 32`` here, the JAX package's limit for its
composites (``pallas_sort.py:258-263``), so that ``"auto"`` picks the
reference's routes; wider windows take the binning passes.

On a CPU tensor :func:`sort_by_digits_small` runs
:func:`sort_by_digits_small_plain`, a stable ``torch.sort`` of the digits and
a gather; on a CUDA tensor it launches the kernel or raises.
:func:`rank_scatter_emulated` repeats the kernel's ranking step for step in
torch, for the CPU tests of its arithmetic.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .bits import KEY_BITS, sortable_digits, to_int64, validate_digit_range
from .block_sort import check_keys

MAX_N_KV = 1 << 14  # keys one block sorts (16 a thread)
RANK_THREADS = 1024  # threads of a ranking block (kRankThreads in csrc/block_rank.cuh)
RANK_WIDTH = 8  # bits one counting pass sorts by
_WARP = 32
_PAD = 0xFFFFFFFF

launches = 0  # kernel launches, for showing that a run went through the kernel


def pos_bits(n: int) -> int:
    """Bits of the position in the JAX package's composite: log2 of
    next_pow2(n)."""
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


def rank_keys_per_thread(n: int) -> int:
    """Keys a thread of the ranking block holds for n slots: ceil(n / 1024),
    at least 1.  The block holds RANK_THREADS times that many slots."""
    return max(1, -(-n // RANK_THREADS))


def rank_scatter_emulated(slots: torch.Tensor, shift: int, width: int) -> torch.Tensor:
    """One counting pass of ``csrc/block_rank.cuh`` in torch: the block's
    ``slots`` (uint32, RANK_THREADS * K of them) stably sorted by bits
    [shift, shift + width), width <= 8, computed as the kernel computes it.

    Slot ``w*32K + k*32 + l`` is key k of lane l in warp w.  Each key adds
    one to its warp's counter of its digit; an exclusive scan over the
    (digit, warp) counters, digit-major, gives each its base; then for each
    k in order the lanes of a warp with equal digits (its peers) advance
    that counter by their number, and a key goes to the counter before the
    advance plus its peers in lower lanes."""
    K = slots.numel() // RANK_THREADS
    warps = RANK_THREADS // _WARP
    D = 1 << width
    d = ((to_int64(slots) >> shift) & (D - 1)).view(warps, K, _WARP)
    lower = torch.ones(_WARP, _WARP, dtype=torch.bool).tril(-1)  # [lane, lower lane]
    below = ((d[..., :, None] == d[..., None, :]) & lower).sum(-1)  # (warps, K, lanes)
    added = torch.zeros(warps, K, D, dtype=torch.int64).scatter_add_(
        2, d, torch.ones_like(d))  # each k's advance of a warp's counters
    before = torch.cumsum(added, 1) - added  # the advance so far, before k's
    counts = added.sum(1).T.reshape(-1)  # (digit, warp), digit-major
    base = (torch.cumsum(counts, 0) - counts).view(D, warps)
    w = torch.arange(warps)[:, None, None]
    pos = base[d, w] + before.gather(2, d) + below
    out = torch.empty_like(slots)
    out.view(torch.int32)[pos.reshape(-1)] = slots.view(torch.int32)
    return out


def sort_by_digits_small_emulated(
    keys: torch.Tensor, offset: int, width: int
) -> torch.Tensor:
    """``digit_sort_kernel``'s arithmetic on CPU tensors: the n keys padded
    with 0xFFFFFFFF to the block's 1024K slots, then LSD passes of
    :func:`rank_scatter_emulated`, 8 bits a pass and the last one narrower;
    the first n slots are the result."""
    n = keys.numel()
    slots = torch.full((RANK_THREADS * rank_keys_per_thread(n),), _PAD,
                       dtype=torch.uint32)
    slots[:n] = keys
    for done in range(0, width, RANK_WIDTH):
        slots = rank_scatter_emulated(slots, offset + done, min(RANK_WIDTH, width - done))
    return slots[:n]


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
