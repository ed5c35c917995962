"""Ragged bucket exchange: each sender writes its per-peer slices straight
into the receivers' buffers (B6).

Port of ``gpu_radix_sort_tpu/parallel/rdma_exchange.py``.  On the TPU one
Pallas program a chip issued remote DMAs of 16-row chunks at offsets
derived from the all-gathered counts, behind an entry barrier, and drained
semaphores; chunk rounding left slack slots in the receive buffer, masked
by ``tags == D``.  Here:

  * the schedule is built on the device from the gathered (P, D) counts:
    ``M[src, dst]`` (:func:`send_matrix`, the closed form of
    rdma_exchange.py:234-244) and, for each sender, P segments
    (src_start, count, dst_rank, dst_start) exact to the element
    (:func:`segments`).  Nothing is synchronised with the host;
  * :func:`segment_copy`, the wrapper of ``segment_copy_kernel`` in
    ``csrc/exchange.cu``, copies every segment into its receiver's buffer,
    one launch for each sender and round.  Rank c's buffer holds exactly its
    n_local keys, each source's slice in source order, so there are no slack
    slots and ``tags`` are the plain digits.  Each block walks the segments
    that meet its 2^14 source keys and stores each one's part as 16-byte
    vectors aligned on the receiver, built from aligned 16-byte loads of the
    source, between a head and a tail of at most 3 keys
    (:func:`segment_copy_emulated` repeats that walk for the CPU tests);
  * the barrier and the drains become stream order (:func:`begin_sends`,
    :func:`end_sends`): before any sender launches, its stream waits on an
    event recorded on each receiver's stream after the receive buffers were
    allocated, and after the launches each receiver's stream waits on every
    sender.  Ranks that share a device share its stream, and then nothing is
    recorded.  Across cards the stores go through peer access, enabled once
    for each pair; where ``cudaDeviceCanAccessPeer`` says no, the exchange
    raises, it never copies through the host;
  * on a process-group mesh (:mod:`.multihost`) the receive buffers are the
    built sort's :class:`~.peer_memory.PeerBuffers`, made once: the local
    ranks' own, and the other processes' mapped through CUDA IPC (shared
    memory on the CPU).  A sender's segments are those of its global rank
    ``mesh.first + i``.  Two rules order the stores against the receivers'
    reads: before a sender stores into a buffer, its owner is past its last
    read of it, and before any receiver reads, every store is complete.
    The round's gather of the counts is the first point (every process has
    enqueued its reads before it; over NCCL it is ordered on every card's
    stream, over gloo it waits for the card), and
    :func:`.peer_memory.drain` after the sends the second.  Two
    ``torch.distributed`` calls a round, as for ``alltoall``.

On a CPU tensor :func:`segment_copy` runs :func:`segment_copy_plain`, a loop
of slice assignments; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build
from ..ops.block_sort import check_keys
from ..ops.boundaries import digit_counts_sorted
from ..ops.radix_sort import sort_by_digits
from ..utils.timers import span
from .exchange import _run_starts_global, _slice_counts, digits_i32
from .mesh import KeyMesh, all_gather, global_ranks
from .peer_memory import PeerBuffers, drain

MAX_RANKS = 256  # receivers one launch addresses (kMaxRanks in csrc/exchange.cu)
COPY_CHUNK = 1 << 14  # source keys a segment_copy block sends (kCopyChunk)

launches = 0  # kernel launches, for showing that a run went through the kernel

_peer_pairs: set[tuple[int, int]] = set()


def send_matrix(all_counts: torch.Tensor, n_local: int) -> torch.Tensor:
    """M[i, c]: how many of rank i's keys go to rank c, from the (P, D)
    digit counts of every rank (int64 (P, P))."""
    P = all_counts.shape[0]
    S_all = _run_starts_global(all_counts)
    bounds = torch.arange(P + 1, dtype=torch.int64, device=all_counts.device) * n_local
    below = _slice_counts(S_all, all_counts, bounds[:, None])  # (P+1, P)
    return (below[1:] - below[:-1]).t().contiguous()


def segments(M: torch.Tensor, src: int) -> torch.Tensor:
    """Rank ``src``'s P segments as a (4, P) int64 tensor: src_start, count,
    dst_rank, dst_start.  The receive layout is source-major: rank c's
    slice from src lands after every earlier source's."""
    row = M[src]
    dst_start = (torch.cumsum(M, 0) - M)[src]
    rank = torch.arange(M.shape[1], dtype=torch.int64, device=M.device)
    return torch.stack([torch.cumsum(row, 0) - row, row, rank, dst_start])


def check_receivers(src: torch.Tensor, recv: list) -> None:
    """What a launch that writes into ``recv`` needs: uint32 keys, at most
    MAX_RANKS receivers, every tensor on CUDA or every one on the CPU."""
    check_keys(src)
    for r in recv:
        check_keys(r)
    if not 1 <= len(recv) <= MAX_RANKS:
        raise ValueError(f"one launch addresses 1 to {MAX_RANKS} receivers, got {len(recv)}")
    if {src.device.type, *(r.device.type for r in recv)} != {src.device.type}:
        raise ValueError("the source and the receive buffers must all be on CUDA or all on the CPU")


def _check_segments(src: torch.Tensor, segs: torch.Tensor, recv: list) -> None:
    check_receivers(src, recv)
    if (segs.dtype != torch.int64 or segs.dim() != 2 or segs.shape[0] != 4
            or segs.shape[1] < 1 or not segs.is_contiguous()):
        raise TypeError(f"segments must be a contiguous (4, S) int64 tensor, got "
                        f"{segs.dtype} {tuple(segs.shape)}")
    if segs.device != src.device:
        raise ValueError(f"segments on {segs.device} but the source on {src.device}")


def segment_copy_plain(src: torch.Tensor, segs: torch.Tensor, recv: list) -> None:
    """Plain PyTorch version of :func:`segment_copy`: one slice assignment a
    segment."""
    for s0, count, rank, d0 in segs.t().tolist():
        if count:
            out = recv[rank].view(torch.int32)
            out[d0:d0 + count] = src.view(torch.int32)[s0:s0 + count].to(out.device)


def segment_copy_emulated(src: torch.Tensor, segs: torch.Tensor, recv: list, *,
                          src_shift: int = 0, dst_shifts: list | None = None,
                          chunk: int = COPY_CHUNK) -> dict:
    """``segment_copy_kernel``'s walk on CPU tensors, writing into ``recv``.

    Key i of ``src`` is word i + ``src_shift`` of a 16-byte aligned array,
    key k of ``recv[c]`` word k + ``dst_shifts[c]`` of another (the shifts are
    0 to 3, the addresses' word offsets past a 16-byte boundary).  Each block
    takes ``chunk`` source keys, finds the segments that meet them by two
    searches, and stores each segment's part there as a head of keys up to
    the receiver's next 16-byte boundary, then 4-key vectors aligned there,
    each from one aligned source vector or, where the receiver lags, from
    two, then a tail.  Returns how many of each it stored, and the parts cut
    at a block's edge."""
    n = src.numel()
    dst_shifts = dst_shifts or [0] * len(recv)
    seg_src, seg_count, seg_rank, seg_dst = (row.tolist() for row in segs)
    starts = segs[0].contiguous()
    # the aligned source: whole 16-byte vectors around the keys
    n_words = -(-(n + src_shift) // 4) * 4
    words = torch.zeros(n_words + 4, dtype=torch.int32)
    words[src_shift:src_shift + n] = src.view(torch.int32)
    stats = {"head": 0, "vectors": 0, "lagged": 0, "tail": 0, "cut": 0}
    for first in range(0, n, chunk):
        last = min(first + chunk, n) - 1
        lo, hi = (max(int(torch.searchsorted(starts, torch.tensor(v), right=True)) - 1, 0)
                  for v in (first, last))
        for s in range(lo, hi + 1):
            a = max(seg_src[s], first)
            b = min(seg_src[s] + seg_count[s], last + 1)
            if a >= b:
                continue
            stats["cut"] += (b - a) < seg_count[s]
            c, d = seg_rank[s], seg_dst[s] + (a - seg_src[s])
            out = recv[c].view(torch.int32)
            head = min(b - a, (-(dst_shifts[c] + d)) % 4)
            nvec, tail = (b - a - head) // 4, (b - a - head) % 4
            out[d:d + head] = words[a + src_shift:a + src_shift + head]
            v0, w = d + head, a + head + src_shift  # the first vector's receiver and source words
            assert nvec == 0 or (dst_shifts[c] + v0) % 4 == 0, "vector store off its boundary"
            lag, base = w % 4, w - w % 4
            rows = words[base:base + 4 * nvec + 4].view(-1, 4)  # aligned source vectors
            vec = rows[:nvec] if lag == 0 else torch.cat([rows[:-1], rows[1:]], 1)[:, lag:lag + 4]
            out[v0:v0 + 4 * nvec] = vec.reshape(-1)
            out[v0 + 4 * nvec:v0 + 4 * nvec + tail] = words[w + 4 * nvec:w + 4 * nvec + tail]
            stats["head"] += head
            stats["vectors"] += nvec
            stats["lagged"] += nvec if lag else 0
            stats["tail"] += tail
    return stats


def segment_copy(src: torch.Tensor, segs: torch.Tensor, recv: list) -> None:
    """B6: ``src[src_start + k] -> recv[dst_rank][dst_start + k]`` for
    k < count, for each segment of ``segs`` (in source order, disjoint).
    Writes into the receive buffers."""
    global launches
    _check_segments(src, segs, recv)
    if src.device.type == "cpu":
        segment_copy_plain(src, segs, recv)
        return
    ptrs = (ctypes.c_longlong * len(recv))(*(r.data_ptr() for r in recv))
    lib = build.load()
    with torch.cuda.device(src.device):
        status = lib.grs_segment_copy_u32(
            src.data_ptr(), src.numel(), segs.data_ptr(), segs.shape[1], ptrs,
            len(recv), torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "segment_copy launch")
    launches += 1


def _cuda_devices(senders: list, recv: list) -> tuple[list, list]:
    """The distinct CUDA devices of the senders and of the receivers, or two
    empty lists when every rank shares one device (or the CPU)."""
    send_devs = list(dict.fromkeys(s.device for s in senders))
    recv_devs = list(dict.fromkeys(r.device for r in recv))
    if len(set(send_devs) | set(recv_devs)) < 2 or send_devs[0].type != "cuda":
        return [], []
    return send_devs, recv_devs


def _grouped(mesh: KeyMesh | None) -> bool:
    return mesh is not None and mesh.group is not None


def receivers(shards: list, mesh: KeyMesh | None, peers: PeerBuffers | None):
    """A round's (P receive buffers in global rank order, this process's
    own): new ones on a single controller, ``peers``' on a process group."""
    if not _grouped(mesh):
        recv = [torch.empty_like(s) for s in shards]
        return recv, recv
    if peers is None:
        raise ValueError("a round on a process-group mesh stores into PeerBuffers made "
                         "for it by every process of the group; pass peers")
    if peers.n_local != shards[0].numel() or peers.device != shards[0].device:
        raise ValueError(f"the receive buffers hold {peers.n_local} keys on {peers.device}, "
                         f"the shards {shards[0].numel()} on {shards[0].device}")
    return peers.receivers, peers.local


def begin_sends(senders: list, recv: list, mesh: KeyMesh | None = None) -> None:
    """Before the sends of a round: peer access for each pair of cards, and
    every sender's stream waits until each receiver's stream is past the
    allocation of its buffer (the TPU kernel's entry barrier).  On a
    process-group mesh nothing: the round's gather of the counts, before
    the sends, is that point for every process."""
    if _grouped(mesh):
        return
    send_devs, recv_devs = _cuda_devices(senders, recv)
    for a in send_devs:
        for b in recv_devs:
            if a != b and (a.index, b.index) not in _peer_pairs:
                build.check(build.load().grs_enable_peer_access(a.index, b.index),
                            f"peer access from {a} to {b}")
                _peer_pairs.add((a.index, b.index))
    for b in recv_devs:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(b))
        for a in send_devs:
            if a != b:
                torch.cuda.current_stream(a).wait_event(ready)


def end_sends(senders: list, recv: list, mesh: KeyMesh | None = None) -> None:
    """After the sends: each receiver's stream waits on every sender (the
    TPU kernel's send and receive drains); on a process-group mesh every
    process's stores complete first (:func:`.peer_memory.drain`)."""
    if _grouped(mesh):
        drain(mesh)
        return
    send_devs, recv_devs = _cuda_devices(senders, recv)
    for a in send_devs:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(a))
        for b in recv_devs:
            if a != b:
                torch.cuda.current_stream(b).wait_event(done)


def exchange_round_rdma_raw(sorted_shards: list, offset: int, width: int,
                            mesh: KeyMesh | None = None, peers: PeerBuffers | None = None):
    """The ragged exchange without the reassembly sort: takes this
    process's digit-sorted shards, returns lists ``(tags, flat,
    overflowed)`` (the contract of ``exchange.exchange_round_alltoall_raw``):
    ``flat`` is rank c's receive buffer of exactly n_local keys, ``tags``
    their digits (no slot carries the sentinel D), ``overflowed`` False.
    On a process-group ``mesh`` the buffers are ``peers``' (the next round
    writes them again)."""
    n_local = sorted_shards[0].numel()
    counts = [digit_counts_sorted(s, offset, width) for s in sorted_shards]
    recv, own = receivers(sorted_shards, mesh, peers)
    _, first = global_ranks(mesh, len(sorted_shards))
    plans: dict[torch.device, torch.Tensor] = {}  # ranks on one device share M
    begin_sends(sorted_shards, recv, mesh)
    for i, (s, all_counts) in enumerate(zip(sorted_shards, all_gather(counts, mesh))):
        if s.device not in plans:
            plans[s.device] = send_matrix(all_counts, n_local)
        segment_copy(s, segments(plans[s.device], first + i), recv)
    end_sends(sorted_shards, recv, mesh)
    tags = [digits_i32(r, offset, width).view(torch.uint32) for r in own]
    return tags, own, [torch.zeros((), dtype=torch.bool, device=r.device) for r in own]


def exchange_round_rdma(shards: list, offset: int, width: int, *,
                        strategy: str | None = None, mesh: KeyMesh | None = None,
                        peers: PeerBuffers | None = None):
    """One distributed digit round through the ragged exchange.  Returns
    (new shards, overflowed per rank): raggedness leaves no capacity to
    overflow.  With no slack the stable reassembly is a stable digit sort of
    each receive buffer."""
    sorted_shards = [sort_by_digits(s, offset, width, strategy=strategy) for s in shards]
    with span("grs.exchange"):
        _, flat, overflowed = exchange_round_rdma_raw(sorted_shards, offset, width, mesh, peers)
    return [sort_by_digits(f, offset, width, strategy=strategy) for f in flat], overflowed
