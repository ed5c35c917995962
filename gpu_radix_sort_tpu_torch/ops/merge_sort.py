"""Device-memory-scale merge sort: tile sort, then merge-path merge levels.

Port of ``gpu_radix_sort_tpu/ops/pallas_merge.py``.  :func:`merge_level` is
the wrapper of ``csrc/merge_path.cu``, which replaces
``pallas_merge.py:335`` ``_merge_kernel`` (B2) and the XLA split search
``_merge_splits`` that fed it.  It keeps the JAX level contract, so it
compares directly with ``pallas_merge.merge_level``: runs of length L
alternate in direction (run r ascending iff r is even) and pair p of runs
comes out as one run of 2L, ascending iff p is even.

    sort_full_large   block_sort(alternate) -> merge_level(L) for
                      L = TILE, 2 TILE, ... while L < n

Bound on this card: each level reads and writes every key once, 8 bytes a
key; at 64M keys the tile pass and 12 levels move 13 x 512 MiB.

Not carried over: ``_rowstage_prep`` / ``stage1_rows`` (an XLA row sort
that shortened the TPU network), ``b_out_top`` (bigger upper-level blocks)
and ``merge_presorted``; the first two are TPU levers to measure again on
the H100, the last belongs to a later slice.  Padding to a power of two is
not needed either: both kernels take a short last run.

On a CPU tensor :func:`merge_level` runs :func:`merge_level_plain`, a sort
of each run pair; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .block_sort import TILE, block_sort, check_keys, sort_runs_plain

B_OUT = 4096  # keys a CUDA block writes (kBlockOut in csrc/merge_path.cu)

launches = 0  # kernel launches, for showing that a run went through the kernel

sort_tiles = block_sort  # the JAX package's name for the tile pass


def merge_level_plain(x: torch.Tensor, L: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`merge_level`: sort each pair of runs,
    odd pairs descending."""
    return sort_runs_plain(x, 2 * L, alternate=True)


def merge_level(x: torch.Tensor, L: int) -> torch.Tensor:
    """One pairwise merge level over alternating-direction sorted runs of
    length ``L`` -> alternating runs of length 2L.  Returns a new tensor."""
    global launches
    check_keys(x)
    if L < 1:
        raise ValueError(f"run length must be >= 1, got {L}")
    if x.device.type == "cpu":
        return merge_level_plain(x, L)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build.load()
    with torch.cuda.device(x.device):
        status = lib.grs_merge_level_u32(
            x.data_ptr(), out.data_ptr(), x.numel(), L,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "merge_level launch")
    launches += 1
    return out


def sort_full_large(keys: torch.Tensor, *, tile: int = TILE) -> torch.Tensor:
    """Ascending sort: tile sort with alternating directions, then merge
    levels until one run is left.  Peak memory: the input and two buffers
    of its size (each level writes a new one and the last is freed)."""
    x = sort_tiles(keys, tile, alternate=True)
    L = tile
    while L < keys.numel():
        x = merge_level(x, L)
        L *= 2
    return x
