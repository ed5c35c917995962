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
    merge_presorted   ascending runs, odd runs reversed -> merge_level(L)
                      for L = run, 2 run, ... while L < n

The kernel writes B_OUT keys a CUDA block: two warps find the block's
merge-path splits, 32 probes a step; the two input slices reach shared
memory as 16-byte loads (heads and tails of <= 3 keys); each thread merges
ITEMS keys; the output leaves as 16-byte stores, reversed for a descending
pair.  Bound on this card: each level reads and writes every key once, 8
bytes a key; at 64M keys the tile pass and 12 levels move 13 x 512 MiB.

Not carried over: ``_rowstage_prep`` / ``stage1_rows`` (an XLA row sort
that shortened the TPU network) and ``b_out_top`` (bigger upper-level
blocks), TPU levers to measure again on the H100.  Padding to a power of
two is not needed either: both kernels take a short last run.

On a CPU tensor :func:`merge_level` runs :func:`merge_level_plain`, a sort
of each run pair; on a CUDA tensor it launches the kernel or raises.
:func:`merge_level_emulated` repeats the kernel's splits, vector heads and
tails, merges and reversed stores in numpy, for the CPU tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from .bits import KEY_DTYPE
from .block_sort import TILE, block_sort, check_keys, sort_runs_plain

THREADS = 512  # threads a block (kThreads in csrc/merge_path.cu)
ITEMS = 16  # keys a thread merges (kItems)
B_OUT = THREADS * ITEMS  # keys a CUDA block writes (kBlockOut)
VEC = 4  # keys a 16-byte load or store of device memory (kVec)

launches = 0  # kernel launches, for showing that a run went through the kernel

sort_tiles = block_sort  # the JAX package's name for the tile pass


def merge_level_plain(x: torch.Tensor, L: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`merge_level`: sort each pair of runs,
    odd pairs descending."""
    return sort_runs_plain(x, 2 * L, alternate=True)


def _split_warp(x: np.ndarray, base: int, la: int, lb: int, diag: int) -> int:
    """``split_warp``: A keys among the first ``diag`` of the pair's merge,
    A first on ties, by 32 probes a step."""
    lo, hi = max(0, diag - lb), min(diag, la)
    end = base + la + lb
    while lo < hi:
        step = (hi - lo + 31) >> 5
        i = lo + step * np.arange(32)
        ok = i < hi
        j = np.where(ok, i, lo)
        below = ok & (x[base + j] <= x[end - diag + j])
        c = int(below.sum())
        assert bool(below[:c].all()), "the probes below are a prefix of the lanes"
        if c == 0:
            hi = lo
        else:
            lo, hi = lo + (c - 1) * step + 1, min(hi, lo + c * step)
    return lo


def _head(word: int, count: int) -> int:
    """``head_keys``: keys before the first 16-byte boundary of a word."""
    return min(count, -word & 3)


def merge_level_emulated(
    x: torch.Tensor, L: int, *, threads: int = THREADS, items: int = ITEMS,
    x_word: int = 0, out_word: int = 0,
) -> torch.Tensor:
    """``merge_level_kernel``'s arithmetic on a CPU tensor, block by block:
    the two warp-searched splits of each output block of threads * items
    keys; the A slice and the stored B slice staged at their device word
    offsets mod 4 (``x_word``: the word offset of x[0]) as the kernel
    writes them, a head of <= 3 keys, VEC-key vectors from a 16-byte
    boundary and a tail, each at the kernel's own shared-memory index; each
    thread's merge path and its ``items`` merged keys; the padded staging;
    the output range, reversed for an odd pair, as a head, vectors aligned
    on ``out_word`` + index and a tail.  Asserts every staged word read was
    written and every key is written exactly once."""
    xs = x.numpy()
    n, b_out = xs.size, threads * items
    out = np.zeros(n, np.uint32)
    if n == 0:
        return torch.from_numpy(out)
    written = np.zeros(n, np.int64)
    pair_len = min(2 * L, n)
    blocks_per_pair = -(-pair_len // b_out)
    pairs = -(-n // pair_len)
    staged_words = b_out + b_out // 32 + 8
    t = np.arange(threads)
    for blk in range(pairs * blocks_per_pair):
        p, k0 = blk // blocks_per_pair, blk % blocks_per_pair * b_out
        base = p * 2 * L
        la, lb = min(L, n - base), max(0, min(L, n - base - L))
        length = la + lb
        if k0 >= length:
            continue
        k1 = min(k0 + b_out, length)
        a0 = _split_warp(xs, base, la, lb, k0)
        na, count = _split_warp(xs, base, la, lb, k1) - a0, k1 - k0
        nb = count - na
        src_a, src_b = base + a0, base + length - (k0 - a0) - nb
        s = np.full(staged_words, -1, np.int64)
        d_a = (x_word + src_a) & 3
        d_b = d_a + na + ((x_word + src_b - d_a - na) & 3)
        for src, dst, cnt in ((src_a, d_a, na), (src_b, d_b, nb)):
            h = _head(x_word + src, cnt)
            nv = (cnt - h) // VEC
            tail = cnt - h - nv * VEC
            assert tail < VEC and h < 4
            assert nv == 0 or ((x_word + src + h) % 4, (dst + h) % 4) == (0, 0)
            for j in (np.arange(h), h + np.arange(nv * VEC), cnt - tail + np.arange(tail)):
                s[dst + j] = xs[src + j]  # the head, the vectors, the tail
        # each thread's split in shared memory, then its merge
        diag = np.minimum(t * items, count)
        lo, hi = np.maximum(0, diag - nb), np.minimum(diag, na)
        while bool((lo < hi).any()):
            mid = (lo + hi) >> 1
            act = lo < hi
            below = s[d_a + np.where(act, mid, 0)] <= s[d_b + nb - diag + np.where(act, mid, 0)]
            lo = np.where(act & below, mid + 1, lo)
            hi = np.where(act & ~below, mid, hi)
        ai, bi = lo, diag - lo
        merged = np.empty((threads, items), np.int64)
        for i in range(items):
            a_ok, b_ok = ai < na, bi < nb
            ka = np.where(a_ok, s[d_a + np.minimum(ai, max(na - 1, 0))], 0)
            kb = np.where(b_ok, s[d_b + nb - 1 - np.minimum(bi, max(nb - 1, 0))], 0)
            take_a = a_ok & (~b_ok | (ka <= kb))
            merged[:, i] = np.where(take_a, ka, kb)
            ai, bi = ai + take_a, bi + ~take_a
        k = np.arange(b_out)
        s[k + (k >> 5)] = merged.reshape(-1)
        # the output range and its vectors
        descending = p & 1
        dst = base + length - k1 if descending else base + k0
        j = np.arange(count)
        i = count - 1 - j if descending else j
        vals = s[i + (i >> 5)]
        assert bool((vals >= 0).all()), "a merged key came from an unstaged word"
        h = _head(out_word + dst, count)
        nv = (count - h) // VEC
        tail = count - h - nv * VEC
        assert nv == 0 or (out_word + dst + h) % 4 == 0
        for j in (np.arange(h), h + np.arange(nv * VEC), count - tail + np.arange(tail)):
            out[dst + j] = vals[j]
            np.add.at(written, dst + j, 1)
    assert bool((written == 1).all()), "every key is written once"
    return torch.from_numpy(out)


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


def merge_presorted(x: torch.Tensor, run: int) -> torch.Tensor:
    """Ascending sort of a 1-D uint32 tensor that is a sequence of ascending
    runs of ``run`` keys, the last of them possibly shorter: the odd runs
    reversed (the levels' alternating directions), then merge levels only,
    from L = run upward -- no tile pass, and no level below ``run``.  The
    sample sort's presorted-runs reassembly (``parallel/sample_sort.py``).
    Returns a new tensor.

    The JAX package's form (``pallas_merge.py:559-613``) asks for ``run``
    and n/run powers of two and ``run`` at least its window-containment
    bound (``min_presorted_run``); those are TPU bounds.  Here any run >= 1
    and any n will do, as B2 takes a short last run, and on what the JAX
    form accepts both give the same bytes (the sorted keys).  Exact with
    duplicate keys, as :func:`merge_level` is."""
    check_keys(x)
    if run < 1:
        raise ValueError(f"run length must be >= 1, got {run}")
    n = x.numel()
    y = x.view(torch.int32).clone()
    whole = n // run
    runs = y[:whole * run].view(whole, run)
    runs[1::2] = runs[1::2].flip(1)
    if whole % 2 and n % run:  # the short last run is an odd one
        y[whole * run:] = y[whole * run:].flip(0)
    y = y.view(KEY_DTYPE)
    L = run
    while L < n:
        y = merge_level(y, L)
        L *= 2
    return y
