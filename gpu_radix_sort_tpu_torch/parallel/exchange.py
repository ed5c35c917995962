"""Bucket exchange: the all-to-all shuffle of one distributed radix round.

Port of ``gpu_radix_sort_tpu/parallel/exchange.py`` onto the mesh of
:mod:`.mesh`: a shard is a tensor on its rank's device, and each function
takes this process's shards and the mesh (None: the shards alone are a
single-controller mesh), whose collectives are copies between devices or,
on a process-group mesh, one ``torch.distributed`` call each.  The JAX
package's core insight carries over: after a stable local digit sort, each
element's global destination

    g = base[d] + off[my, d] + r

(base = exclusive scan of the digit totals, off = exclusive scan of the
digit's counts over ranks, r = rank within this shard's digit run) is
strictly increasing along the sorted shard, so the elements each peer needs
form one contiguous slice, and a stable digit sort of the receive buffer
restores global destination order.

Three collective exchanges, each with its ``_raw`` form that returns
``(tags, flat, overflowed)`` for each rank (``flat`` the source-major receive
buffer, ``tags`` its digits with the sentinel D = 2^width on padding slots):

  * ``alltoall`` — capacity-bounded slots, one window a peer; overflow is
    detected and reported, never silent;
  * ``overflow`` — a main exchange at the even share plus a small overflow
    slot;
  * ``gather``   — every rank gathers the whole round (exact for any
    distribution).

Destination math is int64 (the JAX package's int32 / ``jax_enable_x64``
switch has no counterpart).  The stable reassembly of the unfused loop is
the port's own stable digit sort of ``flat`` by ``tags`` (a key-value digit
sort over width + 1 bits), which equals JAX's
``lax.sort_key_val(tags, flat, is_stable=True)``.
"""

from __future__ import annotations

import torch

from ..ops.boundaries import digit_counts_sorted
from ..ops.radix_sort import sort_by_digits, sort_key_value_by_digits
from ..utils.timers import span
from .mesh import KeyMesh, all_gather, all_to_all, global_ranks

PAD_KEY = -1  # 0xFFFFFFFF as int32


def default_capacity(n_local: int, nchips: int, capacity_factor: float) -> int:
    """Per-peer slot capacity for the padded all-to-all."""
    if nchips == 1:
        return n_local
    even = -(-n_local // nchips)
    cap = int(even * capacity_factor) + 64
    return min(n_local, cap)


def overflow_capacities(n_local: int, nchips: int, ov_frac: float = 0.25):
    """(C0, C_ov) for the two-pass exchange: C0 is the EVEN share (factor
    1.0) and C_ov a small static overflow slot."""
    if nchips == 1:
        return n_local, 64
    even = -(-n_local // nchips)
    c_ov = min(n_local, max(64, int(even * ov_frac)))
    return min(n_local, even), c_ov


def digits_i32(keys: torch.Tensor, offset: int, width: int) -> torch.Tensor:
    """Bits [offset, offset+width) of uint32 keys (width < 32) as int32."""
    return (keys.view(torch.int32) >> offset) & ((1 << width) - 1)


def _run_starts_global(all_counts: torch.Tensor) -> torch.Tensor:
    """S[i, d] = global destination index of rank i's first element with
    digit d, given all_counts (P, D) in rank order.  int64 (P, D)."""
    counts = all_counts.to(torch.int64)
    totals = counts.sum(0)
    base = torch.cumsum(totals, 0) - totals  # global digit starts
    off = torch.cumsum(counts, 0) - counts  # exclusive over ranks
    return base[None, :] + off


def _slice_counts(S: torch.Tensor, counts: torch.Tensor, bound) -> torch.Tensor:
    """Number of elements with destination < bound, per digit run:
    sum_d clip(bound - S[..., d], 0, counts[..., d]), int64.  ``bound`` is a
    number or a tensor that broadcasts against ``S.shape[:-1]``."""
    b = torch.as_tensor(bound, dtype=torch.int64, device=S.device)
    below = (b[..., None] - S).clamp(min=0)
    return torch.minimum(below, counts.to(torch.int64)).sum(-1)


def _round_metadata_sorted(sorted_shards: list, offset: int, width: int,
                           mesh: KeyMesh | None = None):
    """For each local rank, from the all-gathered (P, D) count matrix: its
    send slice bounds (P+1,), the counts it sends to each peer (P,) and the
    counts it receives from each (P,), int64 on its device."""
    n_local = sorted_shards[0].numel()
    P, first = global_ranks(mesh, len(sorted_shards))
    counts = [digit_counts_sorted(s, offset, width) for s in sorted_shards]
    meta = []
    for i, (c, all_counts) in enumerate(zip(counts, all_gather(counts, mesh))):
        my = first + i
        S_all = _run_starts_global(all_counts)
        bounds = torch.arange(P + 1, dtype=torch.int64, device=c.device) * n_local
        send_bounds = _slice_counts(S_all[my], c, bounds)
        # bounds on the device: a Python int would be copied from the host,
        # and that copy waits for the card
        recv_count = (_slice_counts(S_all, all_counts, bounds[my + 1])
                      - _slice_counts(S_all, all_counts, bounds[my]))
        meta.append((send_bounds, send_bounds[1:] - send_bounds[:-1], recv_count))
    return meta


def send_windows(padded: torch.Tensor, starts: torch.Tensor, capacity: int) -> torch.Tensor:
    """Per-peer send buffer: row c = ``padded[starts[c] : starts[c] +
    capacity]``.  Callers pad the tail so no window runs out of bounds."""
    idx = starts[:, None] + torch.arange(capacity, device=padded.device)
    return padded[idx]


def _padded(sorted_local: torch.Tensor, pad: int) -> torch.Tensor:
    fill = torch.full((pad,), PAD_KEY, dtype=torch.int32, device=sorted_local.device)
    return torch.cat([sorted_local.view(torch.int32), fill])


def _tagged(recv: torch.Tensor, valid: torch.Tensor, offset: int, width: int):
    """(tags, flat) of a (P, C) int32 receive buffer: digits, or D where a
    slot holds no key of this round."""
    tags = torch.where(valid, digits_i32(recv, offset, width), 1 << width)
    return tags.reshape(-1).view(torch.uint32), recv.reshape(-1).view(torch.uint32)


def _reassemble(tags: torch.Tensor, flat: torch.Tensor, n_local: int,
                width: int, strategy: str | None) -> torch.Tensor:
    """The round's stable reassembly: ``flat`` stably sorted by ``tags``,
    first n_local."""
    _, out = sort_key_value_by_digits(tags, flat, 0, width + 1, strategy=strategy)
    return out[:n_local]


def exchange_round_alltoall_raw(sorted_shards: list, offset: int, width: int,
                                capacity: int, mesh: KeyMesh | None = None):
    """The all-to-all exchange without the reassembly sort: takes the
    digit-sorted shards, returns lists ``(tags, flat, overflowed)`` with one
    entry a local rank."""
    meta = _round_metadata_sorted(sorted_shards, offset, width, mesh)
    blocks, overflowed = [], []
    for s, (send_bounds, send_count, _) in zip(sorted_shards, meta):
        overflowed.append(torch.any(send_count > capacity))
        blocks.append(send_windows(_padded(s, capacity), send_bounds[:-1], capacity))
    tags, flat = [], []
    for recv, (_, _, recv_count) in zip(all_to_all(blocks, mesh), meta):
        k = torch.arange(capacity, device=recv.device)
        t, f = _tagged(recv, k[None, :] < recv_count[:, None], offset, width)
        tags.append(t)
        flat.append(f)
    return tags, flat, overflowed


def exchange_round_alltoall(shards: list, offset: int, width: int, capacity: int,
                            *, strategy: str | None = None, mesh: KeyMesh | None = None):
    """One distributed digit round: local stable digit sort, capacity-bounded
    all-to-all, stable reassembly.  Returns (new shards, overflowed per
    rank)."""
    sorted_shards = [sort_by_digits(s, offset, width, strategy=strategy) for s in shards]
    with span("grs.exchange"):
        tags, flat, overflowed = exchange_round_alltoall_raw(
            sorted_shards, offset, width, capacity, mesh
        )
    n_local = shards[0].numel()
    return [_reassemble(t, f, n_local, width, strategy) for t, f in zip(tags, flat)], overflowed


def exchange_round_alltoall_overflow_raw(sorted_shards: list, offset: int, width: int,
                                         capacity0: int, capacity_ov: int,
                                         mesh: KeyMesh | None = None):
    """Two-pass exchange without the reassembly sort (the contract of
    :func:`exchange_round_alltoall_raw`): a main all-to-all at the even
    share plus an overflow all-to-all of each pair's excess; each source's
    main chunk then its overflow chunk keep the receive order (src, rank)."""
    meta = _round_metadata_sorted(sorted_shards, offset, width, mesh)
    main, over, overflowed = [], [], []
    for s, (send_bounds, send_count, _) in zip(sorted_shards, meta):
        send1 = torch.clamp(send_count, max=capacity0)
        overflowed.append(torch.any(send_count - send1 > capacity_ov))
        padded = _padded(s, capacity0 + capacity_ov)
        main.append(send_windows(padded, send_bounds[:-1], capacity0))
        over.append(send_windows(padded, send_bounds[:-1] + send1, capacity_ov))
    tags, flat = [], []
    for r1, r2, (_, _, recv_count) in zip(all_to_all(main, mesh), all_to_all(over, mesh), meta):
        recv1 = torch.clamp(recv_count, max=capacity0)
        k1 = torch.arange(capacity0, device=r1.device)
        k2 = torch.arange(capacity_ov, device=r1.device)
        valid = torch.cat([k1[None, :] < recv1[:, None],
                           k2[None, :] < (recv_count - recv1)[:, None]], dim=1)
        t, f = _tagged(torch.cat([r1, r2], dim=1), valid, offset, width)
        tags.append(t)
        flat.append(f)
    return tags, flat, overflowed


def exchange_round_alltoall_overflow(shards: list, offset: int, width: int,
                                     capacity0: int, capacity_ov: int, *,
                                     strategy: str | None = None,
                                     mesh: KeyMesh | None = None):
    """One round through the two-pass exchange; a pair exceeding C0 + C_ov
    is reported as overflow."""
    sorted_shards = [sort_by_digits(s, offset, width, strategy=strategy) for s in shards]
    with span("grs.exchange"):
        tags, flat, overflowed = exchange_round_alltoall_overflow_raw(
            sorted_shards, offset, width, capacity0, capacity_ov, mesh
        )
    n_local = shards[0].numel()
    return [_reassemble(t, f, n_local, width, strategy) for t, f in zip(tags, flat)], overflowed


def exchange_round_gather(shards: list, offset: int, width: int, *,
                          strategy: str | None = None, mesh: KeyMesh | None = None):
    """Exact all-gather exchange: each rank digit-sorts the gathered round
    and keeps its slice (ranks on one device share the sort)."""
    n_local = shards[0].numel()
    _, first = global_ranks(mesh, len(shards))
    by_device: dict[torch.device, torch.Tensor] = {}
    out = []
    with span("grs.exchange"):
        every = all_gather([s.view(torch.int32) for s in shards], mesh)
    for i, gathered in enumerate(every):
        my, dev = first + i, gathered.device
        if dev not in by_device:
            by_device[dev] = sort_by_digits(gathered.reshape(-1).view(torch.uint32),
                                            offset, width, strategy=strategy)
        out.append(by_device[dev][my * n_local:(my + 1) * n_local])
    return out, [torch.zeros((), dtype=torch.bool, device=s.device) for s in shards]
