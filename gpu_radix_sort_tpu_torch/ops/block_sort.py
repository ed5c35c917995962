"""Tile sort of uint32 keys: the wrapper of ``block_sort_kernel`` in
``csrc/block_sort.cu``.

Replaces ``gpu_radix_sort_tpu/ops/pallas_merge.py:131`` ``_tile_sort_kernel``
(B1, with ``sort_tiles``).  :func:`block_sort` sorts each consecutive
``tile`` keys; with ``alternate`` odd tiles descend (the merge levels' input
convention).  The last tile may be short.  The one-block sort of n <= TILE
keys (B3) is ``ops/single_block.py``.

The kernel runs the windowed bitonic network of
``csrc/register_bitonic.cuh``: every CUDA block spans 2^TILE_LOG slots, 32
slots a thread in registers, and runs the network's phases 1..log2(tile), so
it sorts each tile of the block on its own.  Phases up to 2^9 run in the
first layout (strides below 32 in a thread, the next five across lanes by
shuffles); each larger phase moves the keys through shared memory into
"windows" whose register bits are five other slot bits
(:func:`window_plan`).  Bound on this card: the 105 compare-exchange stages
a key at 2^14-key tiles (the integer and shuffle/shared-memory pipes), not
the 8 bytes a key of device memory.

On a CPU tensor the wrapper runs :func:`block_sort_plain`, a row-wise
``torch.sort``; on a CUDA tensor it launches the kernel or raises.
:func:`windowed_network_emulated` repeats the kernel's schedule, layouts,
shared-memory words, pads and directions in torch, for the CPU tests;
:func:`tile_network_emulated` the same compare-exchanges with every lane
stride by shuffles (B3's network, ``register_bitonic_sort``).
"""

from __future__ import annotations

import torch

from ..kernels import build
from .bits import KEY_DTYPE, decode_ordered, encode_ordered, from_int64, to_int64

TILE = 1 << 14  # largest tile csrc/block_sort.cu takes (kMaxTile)
TILE_LOG = 14  # slots a block of the tile pass spans (kTileLog)
TILE_REG_LOG = 5  # slot bits a thread holds in registers (kTileRegLog): 32 keys
LANE_LOG = 5  # slot bits of the lanes of a warp
_ONES = 0xFFFFFFFF

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


def stage_kind(j: int, reg_log: int) -> str:
    """Where a compare-exchange of stride 2^j runs: "thread" (two registers
    of a thread), "lane" (a shuffle across a warp) or "shared" (a barrier
    and shared memory, between warps)."""
    return "thread" if j < reg_log else "lane" if j < reg_log + LANE_LOG else "shared"


def network_schedule(phases: int, reg_log: int) -> list[tuple[int, int, str]]:
    """The network's stages over phases 1..``phases`` in order: (phase p,
    stride bit j, kind); phase p merges runs of 2^p slots."""
    return [(p, j, stage_kind(j, reg_log))
            for p in range(1, phases + 1) for j in range(p - 1, -1, -1)]


def tile_network_emulated(
    keys: torch.Tensor, tile: int, *, alternate: bool = False,
    reg_log: int = TILE_REG_LOG, block_log: int = TILE_LOG,
) -> torch.Tensor:
    """``register_bitonic_sort``'s arithmetic on CPU tensors: blocks of
    2^block_log slots, slot 2^block_log b + 2^reg_log t + r in register r of
    thread t of block b; past n, the pad that sorts last in its tile's final
    direction (0xFFFFFFFF ascending, 0 descending).  Phases 1..log2(tile),
    each stage exchanging with the register, lane or thread that
    :func:`network_schedule` names and keeping the minimum at the lower
    slot, with the keys of descending slots held complemented (bit p of the
    slot in phase p; in the last phase bit log2(tile) under ``alternate``,
    else none).  Returns the first n slots."""
    n, t = keys.numel(), tile.bit_length() - 1
    blocks = max(1, -(-n // (1 << block_log)))
    threads, regs = 1 << (block_log - reg_log), 1 << reg_log
    slot = torch.arange(blocks << block_log).view(blocks, threads, regs)
    thread = torch.arange(threads)

    def descending(p: int) -> torch.Tensor:  # all ones where phase p runs descending
        if p == 0 or not (p < t or alternate):
            return torch.zeros_like(slot)
        return ((slot >> p) & 1) * _ONES

    x = descending(t) ^ _ONES  # the pads
    x.view(-1)[:n] = to_int64(keys)
    schedule = network_schedule(t, reg_log)
    for p in range(1, t + 1):
        x = x ^ descending(p - 1) ^ descending(p)
        for _, j, kind in schedule[p * (p - 1) // 2:p * (p + 1) // 2]:
            if kind == "thread":
                lo = [r for r in range(regs) if not r >> j & 1]
                hi = [r | 1 << j for r in lo]
                a, b = x[..., lo], x[..., hi]
                x[..., lo], x[..., hi] = torch.minimum(a, b), torch.maximum(a, b)
                continue
            m = 1 << (j - reg_log)
            partner = thread ^ m
            same_warp = (thread >> LANE_LOG) == (partner >> LANE_LOG)
            assert bool(same_warp.all()) == (kind == "lane"), (p, j, kind)
            y = x[:, partner]
            lower = ((thread & m) == 0)[None, :, None]
            x = torch.where(lower, torch.minimum(x, y), torch.maximum(x, y))
    x = x ^ descending(t)
    if bool((x > _ONES).any() or (x < 0).any()):
        raise AssertionError("keys left the uint32 range")
    return from_int64(x.reshape(-1)[:n])


def window_plan(p: int, reg_log: int = 5) -> list[tuple[str, int]]:
    """The windowed network's steps in phase p: ("window", K) a round trip
    through shared memory to window K, then ("strides", j) for each stride
    2^j of the phase in order, in the window last entered (window 0 at the
    start of every phase).  Phases up to reg_log + 1 stay in window 0 (one
    stride across lanes at most); later ones go to windows p - 5, p - 10,
    ... while above 0, then to window 0."""
    if p <= reg_log + 1:
        return [("strides", j) for j in range(p - 1, -1, -1)]
    steps, k, top = [], p - reg_log, p - 1
    while True:
        steps += [("window", k)] + [("strides", j) for j in range(top, k - 1, -1)]
        if k == 0:
            return steps
        k, top = max(k - reg_log, 0), k - 1


def padded_word(s):
    """Shared-memory word of slot s: a pad word every 32."""
    return s + (s >> 5)


def window_words(k: int, threads: int, reg_log: int = 5) -> torch.Tensor:
    """(threads, 2^reg_log) shared-memory words of window k: register r of
    thread t holds the slot whose bits [k, k + reg_log) are r and whose
    other bits, in order, are t's; slot s lives at :func:`padded_word`."""
    t = torch.arange(threads)[:, None]
    r = torch.arange(1 << reg_log)[None, :]
    return padded_word((t & ((1 << k) - 1)) | ((t >> k) << (k + reg_log)) | (r << k))


def windowed_network_emulated(
    keys: torch.Tensor, tile: int, *, alternate: bool = False, block_log: int = TILE_LOG,
) -> torch.Tensor:
    """The windowed network of ``csrc/register_bitonic.cuh``
    (``windowed_bitonic_sort``, 32 keys a thread) on CPU tensors: phases as
    in :func:`tile_network_emulated`, but each step of :func:`window_plan`
    either exchanges registers in the current window, shuffles across lanes
    (window 0, stride 2^5), or moves every key through one padded buffer to
    another window, asserting that each store and load of a warp's register
    hits 32 different banks.  Returns the first n slots."""
    reg_log = 5
    n, t = keys.numel(), tile.bit_length() - 1
    blocks = max(1, -(-n // (1 << block_log)))
    threads, regs = 1 << (block_log - reg_log), 1 << reg_log
    slot = torch.arange(blocks << block_log).view(blocks, threads, regs)  # window 0
    thread = torch.arange(threads)

    def descending(p: int) -> torch.Tensor:
        if p == 0 or not (p < t or alternate):
            return torch.zeros_like(slot)
        return ((slot >> p) & 1) * _ONES

    def exchange(x: torch.Tensor, bit: int) -> torch.Tensor:
        lo = [r for r in range(regs) if not r >> bit & 1]
        hi = [r | 1 << bit for r in lo]
        a, b = x[..., lo], x[..., hi]
        x[..., lo], x[..., hi] = torch.minimum(a, b), torch.maximum(a, b)
        return x

    words = {}
    for k in range(block_log - reg_log + 1):
        w = window_words(k, threads, reg_log)
        banks = (w % 32).view(threads // 32, 32, regs)
        assert bool((banks.sort(dim=1).values == torch.arange(32)[:, None]).all()), k
        words[k] = w.reshape(-1)
    x = descending(t) ^ _ONES
    x.view(-1)[:n] = to_int64(keys)
    window = 0
    for p in range(1, t + 1):
        assert window == 0
        x = x ^ descending(p - 1) ^ descending(p)
        for step, v in window_plan(p, reg_log):
            if step == "window":
                buf = torch.full((blocks, padded_word(1 << block_log)), -1,
                                 dtype=torch.int64)
                buf[:, words[window]] = x.reshape(blocks, -1)
                x = buf[:, words[v]].view(blocks, threads, regs)
                assert bool((x >= 0).all())
                window = v
            elif window <= v < window + reg_log:
                x = exchange(x, v - window)
            else:
                assert window == 0 and reg_log <= v < 2 * reg_log, (p, v, window)
                m = 1 << (v - reg_log)
                y = x[:, thread ^ m]
                lower = ((thread & m) == 0)[None, :, None]
                x = torch.where(lower, torch.minimum(x, y), torch.maximum(x, y))
    x = x ^ descending(t)
    return from_int64(x.reshape(-1)[:n])


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
