"""Overlapped exchange: each group of keys is sorted and sent by one block
(B7), so the stores of early groups ride out while later groups sort.

Port of ``gpu_radix_sort_tpu/parallel/rdma_overlap.py``.  On the TPU one
Pallas program a chip walked its groups in order: fetch a tile to VMEM,
sort it by the composite ``digit * tile + rank`` with the bitonic network,
stage it to HBM, start its remote chunk DMAs without waiting; the last group
drained everything.  Here:

  * the shard is split into G groups of ``tile`` keys, a power of two at
    most MAX_TILE = 2^14 (the TPU's cap, 2^16, was a VMEM limit): a block of
    1024 threads holds 16 keys a thread in registers, ranks them by digit
    with the counting sort of ``csrc/block_rank.cuh`` (no composite key) and
    scatters them into shared memory, ~97 KB at 2^14 keys and 8 bits, so two
    blocks share an SM;
  * the (G, D) group histograms are torch ops (an ``index_add_`` of ones
    at ``group * D + digit``; XLA code in the JAX package), all-gathered to
    (P, G, D), which gives ``M[src, group, dst]`` and the receive layout
    (:func:`overlap_schedule`), built on the device;
  * :func:`group_sort_send`, the wrapper of ``group_sort_send_kernel`` in
    ``csrc/exchange.cu``, runs one block a group: the stable sort, then each
    destination's slice of the sorted tile stored straight from shared memory
    into that receiver's buffer.  No staging; blocks run in parallel, so the
    card overlaps the stores of early blocks with the sorting of later ones;
  * ``serial=True`` is the A/B mode: the same kernel sorts only, into a
    staging buffer (:func:`group_sort`), then B6 (``segment_copy``) sends
    the G x P segments, so every sort finishes before any send.  The output
    is the same;
  * the receive layout is (source, group)-major with ascending in-group
    rank and no slack, so a stable digit sort of the receive buffer (the
    port's ``sort_by_digits``) is the round's reassembly, as for ``rdma``;
  * on a process-group mesh the receivers, the sender's global index and
    the ordering of the stores are those of :mod:`.rdma_exchange`: the
    built sort's :class:`~.peer_memory.PeerBuffers`, ``mesh.first + i``, the
    gather of the histograms before the sends and a drain after them.

Width is capped at MAX_WIDTH = 8: the schedule needs counts per group and
digit.  n_local must be a multiple of the tile (``sort_distributed`` rounds
n_local up to GRAIN = 1024, so a power-of-two tile divides it).

On a CPU tensor the wrappers run their plain versions (a stable
``torch.sort`` of the (G, tile) digit rows and a gather, then
``segment_copy_plain``); on CUDA tensors they launch the kernel or raise.
:func:`sort_groups_emulated` repeats the kernel's ranking in torch, for the
CPU tests of its arithmetic.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build
from ..ops.bits import sortable_digits, validate_digit_range
from ..ops.block_sort import check_keys
from ..ops.digit_sort import sort_by_digits_small_emulated
from ..ops.radix_sort import sort_by_digits
from ..utils.timers import span
from .exchange import _run_starts_global, _slice_counts, digits_i32
from .mesh import KeyMesh, all_gather, global_ranks
from .peer_memory import PeerBuffers
from .rdma_exchange import (
    begin_sends, check_receivers, end_sends, receivers, segment_copy, segment_copy_plain,
)

MAX_TILE = 1 << 14  # keys a block ranks (kMaxTile in csrc/exchange.cu)
GRAIN = 1024  # the smallest tile; sort_distributed rounds n_local up to it
MAX_WIDTH = 8

launches = 0  # kernel launches, for showing that a run went through the kernel


def pick_tile(n_local: int) -> int:
    """Largest power-of-two group tile <= MAX_TILE that divides ``n_local``
    (n_local must carry a power-of-two factor >= GRAIN)."""
    t = min(n_local & -n_local, MAX_TILE)
    if t < GRAIN:
        raise ValueError(
            f"n_local {n_local} needs a power-of-two factor >= {GRAIN} for "
            f"the overlapped exchange"
        )
    return t


def _group_hist(keys: torch.Tensor, offset: int, width: int, tile: int) -> torch.Tensor:
    """(G, D) int32 digit counts of each group of ``tile`` keys.  Not
    ``bincount``: on CUDA it reads the largest bin back to the host, which
    would stall the single controller once a rank and round."""
    D = 1 << width
    G = keys.numel() // tile
    group = torch.arange(keys.numel(), dtype=torch.int32, device=keys.device) // tile
    bins = torch.zeros(G * D, dtype=torch.int32, device=keys.device)
    bins.index_add_(0, group * D + digits_i32(keys, offset, width),
                    torch.ones_like(group))
    return bins.view(G, D)


def overlap_schedule(all_counts_g: torch.Tensor, n_local: int):
    """From the (P, G, D) group histograms of every rank: ``start[i, g, c]``,
    where destination c's slice begins in group g's sorted tile of rank i,
    and ``dst_start[i, g, c]``, where it lands in rank c's buffer ((source,
    group)-major).  Both int64 (P, G, P)."""
    P = all_counts_g.shape[0]
    cg = all_counts_g.to(torch.int64)
    S_all = _run_starts_global(cg.sum(1))  # (P, D)
    S_pg = S_all[:, None, :] + torch.cumsum(cg, 1) - cg  # global dest of run starts
    bounds = torch.arange(P + 1, dtype=torch.int64, device=cg.device) * n_local
    # (P+1, P, G): [b, i, g] = #keys of (i, g) destined below b * n_local
    below = _slice_counts(S_pg, cg, bounds[:, None, None])
    M = (below[1:] - below[:-1]).permute(1, 2, 0)  # (P_src, G, P_dst)
    start = torch.cumsum(M, 2) - M
    flat = M.reshape(-1, P)
    dst_start = (torch.cumsum(flat, 0) - flat).reshape(M.shape)
    return start, dst_start


def group_segments(sched: torch.Tensor, tile: int) -> torch.Tensor:
    """The (4, G*P) segments (src_start, count, dst_rank, dst_start) that
    send a sorted (G, tile) staging buffer as ``sched`` = (start, dst_start)
    (2, G, P) says, in source order."""
    start, dst_start = sched
    G, P = start.shape
    end = torch.cat([start[:, 1:], torch.full((G, 1), tile, dtype=torch.int64,
                                              device=start.device)], dim=1)
    base = torch.arange(G, dtype=torch.int64, device=start.device)[:, None] * tile
    rank = torch.arange(P, dtype=torch.int64, device=start.device).expand(G, P)
    return torch.stack([start + base, end - start, rank, dst_start]).reshape(4, -1)


def _check_groups(x: torch.Tensor, tile: int, offset: int, width: int) -> None:
    check_keys(x)
    validate_digit_range(offset, width)
    if width > MAX_WIDTH:
        raise ValueError(f"group sorts take widths <= {MAX_WIDTH}, got {width}")
    if tile < 2 or tile > MAX_TILE or tile & (tile - 1) or x.numel() % tile or not x.numel():
        raise ValueError(
            f"tile must be a power of two in [2, {MAX_TILE}] dividing n > 0; got "
            f"tile {tile}, n {x.numel()}"
        )


def sort_groups_plain(x: torch.Tensor, tile: int, offset: int, width: int) -> torch.Tensor:
    """Each group of ``tile`` keys stably sorted by its digits: a stable
    ``torch.sort`` of the (G, tile) digit rows and a gather."""
    order = torch.sort(sortable_digits(x.view(-1, tile), offset, width), dim=1,
                       stable=True).indices
    return x.view(torch.int32).view(-1, tile).gather(1, order).reshape(-1).view(torch.uint32)


def sort_groups_emulated(x: torch.Tensor, tile: int, offset: int, width: int) -> torch.Tensor:
    """``group_sort_send_kernel``'s sort on CPU tensors: each group is one
    ranking block, padded as ``digit_sort_kernel`` pads its keys and ranked
    in its single pass (width <= 8), so
    :func:`~..ops.digit_sort.sort_by_digits_small_emulated` a group."""
    return torch.cat([sort_by_digits_small_emulated(g, offset, width)
                      for g in x.view(-1, tile)])


def group_sort_send_plain(x: torch.Tensor, tile: int, offset: int, width: int,
                          sched: torch.Tensor, recv: list) -> None:
    """Plain PyTorch version of :func:`group_sort_send`."""
    segment_copy_plain(sort_groups_plain(x, tile, offset, width),
                       group_segments(sched, tile), recv)


def _launch(x, tile, offset, width, sched, recv, stage) -> None:
    global launches
    ptrs = None
    if recv is not None:
        ptrs = (ctypes.c_longlong * len(recv))(*(r.data_ptr() for r in recv))
    lib = build.load()
    with torch.cuda.device(x.device):
        status = lib.grs_group_sort_send_u32(
            x.data_ptr(), x.numel(), tile, offset, width,
            None if sched is None else sched.data_ptr(),
            0 if recv is None else len(recv), ptrs,
            None if stage is None else stage.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "group_sort_send launch")
    launches += 1


def group_sort_send(x: torch.Tensor, tile: int, offset: int, width: int,
                    sched: torch.Tensor, recv: list) -> None:
    """B7: sort each group of ``tile`` keys stably by bits [offset,
    offset+width) and store destination c's slice of group g, which starts
    at ``sched[0, g, c]`` in the sorted tile, at ``sched[1, g, c]`` in
    ``recv[c]``.  Writes into the receive buffers."""
    _check_groups(x, tile, offset, width)
    check_receivers(x, recv)
    G = x.numel() // tile
    if (sched.dtype != torch.int64 or sched.shape != (2, G, len(recv))
            or not sched.is_contiguous() or sched.device != x.device):
        raise TypeError(f"sched must be a contiguous (2, {G}, {len(recv)}) int64 "
                        f"tensor on {x.device}")
    if x.device.type == "cpu":
        group_sort_send_plain(x, tile, offset, width, sched, recv)
        return
    _launch(x, tile, offset, width, sched, recv, None)


def group_sort(x: torch.Tensor, tile: int, offset: int, width: int) -> torch.Tensor:
    """The same kernel in its sort-only mode: each group of ``tile`` keys
    stably sorted by its digits, into a new tensor (the serial mode's
    staging buffer)."""
    _check_groups(x, tile, offset, width)
    if x.device.type == "cpu":
        return sort_groups_plain(x, tile, offset, width)
    stage = torch.empty_like(x)
    _launch(x, tile, offset, width, None, None, stage)
    return stage


def exchange_round_rdma_overlapped_raw(shards: list, offset: int, width: int, *,
                                       tile: int, serial: bool = False,
                                       mesh: KeyMesh | None = None,
                                       peers: PeerBuffers | None = None) -> list:
    """The overlapped exchange without the reassembly sort: this process's
    receive buffers, each of exactly n_local keys in the (source,
    group)-major layout.  Requires ``width <= 8`` and ``n_local`` a
    multiple of ``tile``; ``serial=True`` sorts every group before any send
    (the A/B mode).  On a process-group ``mesh`` the buffers are
    ``peers``' (the next round writes them again)."""
    validate_digit_range(offset, width)
    if width > MAX_WIDTH:
        raise ValueError(
            f"rdma_overlap supports width <= {MAX_WIDTH}, got {width} "
            "(per-group histograms scale with 2^width)"
        )
    n_local = shards[0].numel()
    if tile & (tile - 1) or not GRAIN <= tile <= MAX_TILE:
        raise ValueError(f"tile must be a power of two in [{GRAIN}, {MAX_TILE}], got {tile}")
    if n_local % tile:
        raise ValueError(f"n_local {n_local} must be a multiple of tile {tile}")
    hists = [_group_hist(s, offset, width, tile) for s in shards]
    recv, own = receivers(shards, mesh, peers)
    _, first = global_ranks(mesh, len(shards))
    plans: dict[torch.device, tuple] = {}  # ranks on one device share the schedule
    begin_sends(shards, recv, mesh)
    for i, (s, all_counts_g) in enumerate(zip(shards, all_gather(hists, mesh))):
        if s.device not in plans:
            plans[s.device] = overlap_schedule(all_counts_g, n_local)
        start, dst_start = plans[s.device]
        sched = torch.stack([start[first + i], dst_start[first + i]])
        if serial:
            segment_copy(group_sort(s, tile, offset, width), group_segments(sched, tile), recv)
        else:
            group_sort_send(s, tile, offset, width, sched, recv)
    end_sends(shards, recv, mesh)
    return own


def exchange_round_rdma_overlapped(shards: list, offset: int, width: int, *,
                                   tile: int, serial: bool = False,
                                   strategy: str | None = None,
                                   mesh: KeyMesh | None = None,
                                   peers: PeerBuffers | None = None):
    """One distributed digit round through the overlapped exchange.
    Returns (new shards, overflowed per rank, all False); see
    :func:`exchange_round_rdma_overlapped_raw`."""
    with span("grs.exchange"):
        recv = exchange_round_rdma_overlapped_raw(shards, offset, width, tile=tile,
                                                  serial=serial, mesh=mesh, peers=peers)
    out = [sort_by_digits(r, offset, width, strategy=strategy) for r in recv]
    return out, [torch.zeros((), dtype=torch.bool, device=r.device) for r in recv]
