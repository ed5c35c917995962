"""Tile sort of uint32 keys: the wrapper of ``block_sort_kernel`` in
``csrc/block_sort.cu``.

Replaces ``gpu_radix_sort_tpu/ops/pallas_merge.py:131`` ``_tile_sort_kernel``
(B1, with ``sort_tiles``), one bitonic network per CUDA block in shared
memory.  :func:`block_sort` sorts each consecutive ``tile`` keys; with
``alternate`` odd tiles descend (the merge levels' input convention).  The
last tile may be short.  The one-block sort of n <= TILE keys (B3) is
``ops/single_block.py``.

Bound on this card: shared-memory traffic and one barrier per network stage
(105 stages at TILE = 2^14); device memory sees one read and one write of
each key.  TILE is 2^14 keys (64 KB of shared memory a block) -- the source
says why.

On a CPU tensor the wrapper runs :func:`block_sort_plain`, a row-wise
``torch.sort``; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .bits import KEY_DTYPE, decode_ordered, encode_ordered

TILE = 1 << 14  # largest tile csrc/block_sort.cu takes (kMaxTile)

launches = 0  # kernel launches, for showing that a run went through the kernel


def check_keys(x: torch.Tensor) -> None:
    """The kernels take 1-D contiguous uint32 tensors."""
    if x.dtype != KEY_DTYPE or x.dim() != 1 or not x.is_contiguous():
        raise TypeError(
            f"expected a 1-D contiguous uint32 tensor, got {x.dtype} "
            f"shape {tuple(x.shape)}"
        )
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"keys on {x.device} are neither on the CPU nor on CUDA")


def next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def sort_runs_plain(x: torch.Tensor, run: int, *, alternate: bool) -> torch.Tensor:
    """Plain version shared by both kernels: sort each consecutive ``run``
    keys (the last run may be short); with ``alternate``, odd runs
    descending.  Sorts the order-isomorphic int32 view, which every device
    sorts."""
    y = decode_ordered(x, torch.int32)
    n = y.numel()
    full = n - n % run
    rows = torch.sort(y[:full].view(-1, run), dim=1).values
    tail = torch.sort(y[full:]).values
    if alternate:
        rows[1::2] = rows[1::2].flip(1)
        if (n // run) % 2:
            tail = tail.flip(0)
    return encode_ordered(torch.cat([rows.reshape(-1), tail]))


def block_sort_plain(
    x: torch.Tensor, tile: int = TILE, *, alternate: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of :func:`block_sort`."""
    return sort_runs_plain(x, tile, alternate=alternate)


def block_sort(
    x: torch.Tensor, tile: int = TILE, *, alternate: bool = False
) -> torch.Tensor:
    """Sort each consecutive ``tile`` keys of ``x`` (a power of two <= TILE);
    with ``alternate``, odd tiles descending.  Returns a new tensor."""
    global launches
    check_keys(x)
    if tile < 1 or tile > TILE or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two in [1, {TILE}], got {tile}")
    if x.device.type == "cpu":
        return block_sort_plain(x, tile, alternate=alternate)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build.load()
    with torch.cuda.device(x.device):
        status = lib.grs_block_sort_u32(
            x.data_ptr(), out.data_ptr(), x.numel(), tile, int(alternate),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "block_sort launch")
    launches += 1
    return out

