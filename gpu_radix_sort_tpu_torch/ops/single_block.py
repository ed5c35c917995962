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
from .bits import from_int64, to_int64
from .block_sort import TILE, check_keys, next_pow2, sort_runs_plain

MAX_N = TILE  # keys one block sorts (kMaxTile in csrc/block_sort.cu)
REG_LOG = 4  # slot bits a thread holds in registers (kSingleRegLog): 16 keys
LANE_LOG = 5  # slot bits of the lanes of a warp
_PAD = 0xFFFFFFFF

launches = 0  # kernel launches, for showing that a run went through the kernel


def network_log(n: int, reg_log: int = REG_LOG) -> int:
    """log2 of the slots the kernel's network spans for n keys: at least
    one warp's."""
    return max(reg_log + LANE_LOG, next_pow2(n).bit_length() - 1)


def stage_kind(j: int, reg_log: int = REG_LOG) -> str:
    """Where a compare-exchange of stride 2^j runs: "thread" (two registers
    of a thread), "lane" (a shuffle across a warp) or "shared" (a barrier
    and shared memory, between warps)."""
    return "thread" if j < reg_log else "lane" if j < reg_log + LANE_LOG else "shared"


def network_schedule(log: int, reg_log: int = REG_LOG) -> list[tuple[int, int, str]]:
    """The network's stages over 2^log slots in order: (phase p, stride
    bit j, kind); phase p merges runs of 2^p slots."""
    return [(p, j, stage_kind(j, reg_log))
            for p in range(1, log + 1) for j in range(p - 1, -1, -1)]


def network_emulated(keys: torch.Tensor, reg_log: int = REG_LOG) -> torch.Tensor:
    """``single_block_sort_kernel``'s arithmetic on CPU tensors, with
    2^reg_log keys a thread: the n keys padded with 0xFFFFFFFF to 2^LOG
    slots, slot 2^reg_log t + r in register r of thread t; each stage
    exchanges with the register, lane or thread that
    :func:`network_schedule` names and keeps the minimum at the lower slot,
    with the keys of descending runs held complemented.  Returns the first n
    slots."""
    n = keys.numel()
    log = network_log(n, reg_log)
    threads, regs = 1 << (log - reg_log), 1 << reg_log
    x = torch.full((1 << log,), _PAD, dtype=torch.int64)
    x[:n] = to_int64(keys)
    x = x.view(threads, regs)  # [thread, register]
    slot = torch.arange(1 << log).view(threads, regs)
    t = torch.arange(threads)[:, None]

    def region(p: int) -> torch.Tensor:  # all ones where phase p runs descending
        return ((slot >> p) & 1) * 0xFFFFFFFF

    schedule = network_schedule(log, reg_log)
    for p in range(1, log + 1):
        x = x ^ region(p - 1) ^ region(p) if p > 1 else x ^ region(p)
        for _, j, kind in schedule[p * (p - 1) // 2:p * (p + 1) // 2]:
            if kind == "thread":
                lo = [r for r in range(regs) if not r >> j & 1]
                hi = [r | 1 << j for r in lo]
                a, b = x[:, lo], x[:, hi]
                x[:, lo], x[:, hi] = torch.minimum(a, b), torch.maximum(a, b)
                continue
            m = 1 << (j - reg_log)
            partner = t[:, 0] ^ m
            same_warp = (t[:, 0] >> LANE_LOG) == (partner >> LANE_LOG)
            assert bool(same_warp.all()) == (kind == "lane"), (p, j, kind)
            y = x[partner]
            lower = (t & m) == 0
            x = torch.where(lower, torch.minimum(x, y), torch.maximum(x, y))
    if bool((x > 0xFFFFFFFF).any() or (x < 0).any()):
        raise AssertionError("keys left the uint32 range")
    return from_int64(x.reshape(-1)[:n])


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
