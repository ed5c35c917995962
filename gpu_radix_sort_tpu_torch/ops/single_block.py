"""One-block ascending sort of n <= 2^14 uint32 keys: the wrapper of
``single_block_sort_kernel`` in ``csrc/block_sort.cu``.

Replaces ``gpu_radix_sort_tpu/ops/pallas_sort.py:180`` ``_sort_kernel``
(B3, with ``pallas_sort.sort_full``): a keys-only bitonic network over the
whole array in one program, padded with 0xFFFFFFFF.  Here the network
(``csrc/register_bitonic.cuh``) keeps 16 consecutive slots a thread in
registers, 1024 threads at 2^14 keys: strides 1-8 run inside a thread,
strides 16-256 across the lanes of a warp through shuffles, and only strides
of 512 and up through shared memory, one barrier each (15 of the 105 stages
at 2^14).  The network spans max(2^9, next power of two >= n) slots.

One block on one SM: launch latency and the network's instructions bound
it, not its 8 bytes a key of device memory.

On a CPU tensor :func:`sort_single_block` runs :func:`sort_single_block_plain`
(``torch.sort`` of the int32 view); on a CUDA tensor it launches the kernel
or raises.  :func:`network_emulated` repeats the kernel's schedule, layout
and pads in torch, for the CPU tests.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .block_sort import (
    LANE_LOG, TILE, check_keys, next_pow2, sort_runs_plain, tile_network_emulated,
)

MAX_N = TILE  # keys one block sorts (kMaxTile in csrc/block_sort.cu)
REG_LOG = 4  # slot bits a thread holds in registers (kSingleRegLog): 16 keys

launches = 0  # kernel launches, for showing that a run went through the kernel


def network_log(n: int, reg_log: int = REG_LOG) -> int:
    """log2 of the slots the kernel's network spans for n keys: at least
    one warp's."""
    return max(reg_log + LANE_LOG, next_pow2(n).bit_length() - 1)


def network_emulated(keys: torch.Tensor, reg_log: int = REG_LOG) -> torch.Tensor:
    """``single_block_sort_kernel``'s arithmetic on CPU tensors, with
    2^reg_log keys a thread: one block of the tile network
    (:func:`ops.block_sort.tile_network_emulated`) spanning 2^LOG slots,
    LOG = :func:`network_log`, and all LOG phases ascending; the pads are
    0xFFFFFFFF.  Returns the first n slots."""
    log = network_log(keys.numel(), reg_log)
    return tile_network_emulated(keys, 1 << log, reg_log=reg_log, block_log=log)


def sort_single_block_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.sort`` of the int32 view."""
    return sort_runs_plain(keys, max(keys.numel(), 1), alternate=False)


def sort_single_block(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of n <= MAX_N uint32 keys by one block (B3's route).
    Returns a new tensor."""
    global launches
    check_keys(keys)
    n = keys.numel()
    if n > MAX_N:
        raise ValueError(f"one block sorts at most {MAX_N} keys, got {n}")
    if keys.device.type == "cpu":
        return sort_single_block_plain(keys)
    out = torch.empty_like(keys)
    if n == 0:
        return out
    lib = build.load()
    with torch.cuda.device(keys.device):
        status = lib.grs_single_block_sort_u32(
            keys.data_ptr(), out.data_ptr(), n, torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "single_block_sort launch")
    launches += 1
    return out
