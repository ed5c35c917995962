"""Distributed sample sort (PSRS), the performance-mode distributed sort.

Port of ``gpu_radix_sort_tpu/parallel/sample_sort.py`` onto the mesh of
:mod:`.mesh`, a single controller or a process group (each process loops
over its local ranks; ranks are global in the splitters and the plans).  Where the LSD sort pays 32/width
rounds of a local sort and a full exchange, Parallel Sorting by Regular
Sampling pays one local sort, one splitter-partitioned exchange and one
reassembly.  Phases, each a loop over the ranks:

  1. a local sort of each shard (``sort_full``: B1 and B2, or B3 at
     <= 2^14 keys; the key-value forms a stable sort through binning
     passes, B5);
  2. regular sampling on composite keys: P samples a shard, each the
     triple (key, local rank, rank of the shard), gathered and sorted; the
     global quantiles of the P*P candidates are the P-1 splitters.
     Composites are distinct, so no partition exceeds ~2 n/P whatever the
     keys, duplicates included;
  3. each splitter's local bound from two ``searchsorted`` and a closed
     form over the tie run, giving P contiguous slices of the sorted shard.
     The self-destined slice bypasses the exchange (no capacity bound on
     it: already-sorted input moves nothing); the rest rides a
     capacity-bounded ``mesh.all_to_all`` of send windows.  Overflow is
     detected and reported, never silent;
  4. the reassembly of the received windows and the self slice.

Ties split by (local rank, rank) in the keys-only forms, spreading a hot
key's ties over every rank (equal keys are interchangeable there), and by
(rank, local rank) in the key-value forms, the stable order.

Reassembly: keys only, the received windows masked past each sender's
count and the self slice masked in place, then ``"sort"`` (a ``sort_full``
of the buffer; the mask is 0xFFFFFFFF, which ties only with an equal real
key) or ``"merge"`` (:func:`ops.merge_sort.merge_presorted`: the windows
and the self slice rotated to the front are ascending runs, so merge
levels alone sort the buffer).  Key-value: the valid rows laid out in
(source rank, source position) order -- the self slice in its rank's
place -- by one scatter, then one stable key-value sort of the buffer.
The rows that hold no key lie after every valid row, so a valid 0xFFFFFFFF
key stays ahead of them by stability; no sentinel carries a payload.  The
JAX package sorts by (key, validity, source, rank) instead: the same valid
rows in the same order.

64-bit keys are int64 in the sign-flipped domain
(:func:`ops.bits.encode_ordered64`) inside the mesh: one ``searchsorted``
over them takes the place of the JAX package's search of the lo word
inside each hi word's tie run (``_searchsorted_segments``), with the same
bounds.  The build functions of the 64-bit forms keep the JAX package's (hi, lo)
word lanes at their edge.

Outputs are ragged: each rank returns its sorted buffer and its valid
count.  Nothing inside a sort waits on the host; the host wrappers read
the overflow count and then the valid counts, once a call, as the JAX
package's ``device_get`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ops.bits import (
    INT64_MIN, KEY64_DTYPES, KEY_DTYPE, decode_ordered, decode_ordered64,
    encode_ordered, encode_ordered64, join_words, split_words,
)
from ..ops.merge_sort import merge_presorted
from ..ops.radix_sort import _gather_rows, sort_full, sort_key_value, sort_key_value_u64
from .distributed import OverflowError_, _as_keys, sort_distributed
from .exchange import PAD_KEY
from .exchange import default_capacity as default_pair_capacity
from .mesh import (
    KEY_AXIS, KeyMesh, all_gather, all_to_all, global_ranks, key_mesh, psum, shard,
    single_controller,
)

PAD_KEY64 = -INT64_MIN - 1  # the encoded word 0xFFFF_FFFF_FFFF_FFFF, sortable
_INT32_MIN = -(1 << 31)
_REASSEMBLIES = ("sort", "merge")
_PAYLOAD_ERROR = "values must be (n, W) uint32 or (n, B) uint8 with B % 4 == 0"


@dataclass(frozen=True)
class _KeyForm:
    """How one key width sorts: ``pad`` fills slots that hold no key,
    ``sort`` and ``sort_kv`` sort 1-D keys (with a payload), and
    ``searchable`` gives the sorted keys a dtype whose order
    ``searchsorted`` follows."""

    pad: int
    sort: Callable
    sort_kv: Callable
    searchable: Callable


def _sort_kv32(keys, values):
    k, v = sort_key_value(keys.view(KEY_DTYPE), values)
    return k.view(torch.int32), v


# 32-bit keys travel as the int32 view of uint32; 64-bit keys as sortable int64
_KEYS32 = _KeyForm(
    pad=PAD_KEY,
    sort=lambda x: sort_full(x.view(KEY_DTYPE)).view(torch.int32),
    sort_kv=_sort_kv32,
    searchable=lambda s: s ^ _INT32_MIN,
)
_KEYS64 = _KeyForm(
    pad=PAD_KEY64,
    sort=lambda x: torch.sort(x).values,
    sort_kv=sort_key_value_u64,
    searchable=lambda s: s,
)


def _composite_splitters(samples: torch.Tensor, stride: int, order: str):
    """The P-1 composite splitters from the gathered (P, P) samples
    ``[rank, m]`` (sample m of each sorted shard at local rank m * stride).
    Candidates are (key, local rank, rank) triples; ``order`` is the lex
    order within equal keys: "rank_chip" (keys only) or "chip_rank" (the
    stable order).  Returns (keys, local ranks, ranks), each (P-1,)."""
    P, dev = samples.shape[0], samples.device
    k = samples.reshape(-1)
    flat = torch.arange(P * P, device=dev)
    r, c = flat % P * stride, flat // P
    # the candidates lie in (rank, local rank) order; stable sorts by the
    # later keys first give the lex order
    if order == "rank_chip":
        perm = torch.sort(r, stable=True).indices
        k, r, c = k[perm], r[perm], c[perm]
    perm = torch.sort(k, stable=True).indices
    idx = torch.arange(1, P, device=dev) * P
    return k[perm][idx], r[perm][idx], c[perm][idx]


def _composite_bounds(s: torch.Tensor, spl_k, spl_r, spl_c, my: int, order: str):
    """Each splitter's local bound: how many of the sorted shard's elements,
    as composites (key, local rank = index, rank = my), precede it.  A
    closed form over the splitter key's tie run [lo, hi), whose local ranks
    are its indices."""
    lo = torch.searchsorted(s, spl_k, side="left")
    hi = torch.searchsorted(s, spl_k, side="right")
    prefix = torch.minimum((spl_r - lo).clamp(min=0), hi - lo)
    if order == "rank_chip":
        # (rank', chip) < (r_m, c_m): the ranks below r_m, and r_m itself
        # where this chip comes first
        tie = prefix + ((my < spl_c) & (spl_r >= lo) & (spl_r < hi))
    else:
        # (chip, rank') < (c_m, r_m): earlier chips give their whole tie
        # run, the splitter's own chip its rank prefix
        tie = torch.where(my < spl_c, hi - lo, torch.where(my == spl_c, prefix, 0))
    return lo + tie


def _send_plan(s: torch.Tensor, spl, my: int, P: int, capacity: int, order: str):
    """(send bounds (P+1,), off-diagonal send counts (P,), overflowed) of one
    rank's sorted shard in its searchable form ``s``: the self slice rides
    no window, so only the off-diagonal counts meet the capacity."""
    bounds = _composite_bounds(s, *spl, my, order)
    send_bounds = torch.cat([bounds.new_zeros(1), bounds, bounds.new_full((1,), s.numel())])
    send_count = send_bounds[1:] - send_bounds[:-1]
    peer = torch.arange(P, device=s.device)
    offdiag = torch.where(peer == my, 0, send_count)
    return send_bounds, offdiag, (offdiag > capacity).any()


def _windows(x: torch.Tensor, starts: torch.Tensor, capacity: int) -> torch.Tensor:
    """Rows ``x[starts[c] : starts[c] + capacity]`` for each peer c, as
    (P, capacity, ...); rows past x's end repeat its last row (receivers
    mask every row past the sender's count)."""
    n = x.shape[0]
    dtype = torch.int32 if n + capacity < 1 << 31 else torch.int64
    idx = starts.to(dtype)[:, None] + torch.arange(capacity, dtype=dtype, device=x.device)
    rows = _gather_rows(x, idx.clamp_(max=n - 1).view(-1))
    return rows.view(starts.numel(), capacity, *x.shape[1:])


def _merge_buffer(recv, valid, s, self_lo, self_hi, pad: int, presorted: bool):
    """The keys-only reassembly buffer: the received windows masked past
    their counts, then the self slice -- masked in place, or (``presorted``)
    rotated to the front and masked after it, so that every window and the
    self slice are ascending runs."""
    P, C = recv.shape
    n = s.numel()
    buf = torch.empty(P * C + n, dtype=s.dtype, device=s.device)
    pad = s.new_full((), pad)
    torch.where(valid, recv, pad, out=buf[:P * C].view(P, C))
    pos = torch.arange(n, dtype=torch.int32 if 2 * n < 1 << 31 else torch.int64, device=s.device)
    if presorted:
        count = (self_hi - self_lo).to(pos.dtype)
        rotated = s.index_select(0, (pos + self_lo.to(pos.dtype)).clamp_(max=n - 1))
        torch.where(pos < count, rotated, pad, out=buf[P * C:])
    else:
        torch.where((pos >= self_lo) & (pos < self_hi), s, pad, out=buf[P * C:])
    return buf


def _kv_layout(valid_rx, recv_count, self_lo, self_hi, my: int, n: int):
    """For the key-value reassembly: the layout index of each row of the
    compacted buffer -- valid rows first, in (source rank, source position)
    order with the self slice in rank ``my``'s place, then the other rows --
    and the number of valid rows.  Layout: the P received windows, then the
    n rows of the sorted shard."""
    P, C = valid_rx.shape
    dev = valid_rx.device
    count = recv_count.clamp(max=C)  # where a window overflowed, its first C
    count[my] = self_hi - self_lo
    first = torch.cumsum(count, 0) - count  # each source's first output row
    total = count.sum()
    k = torch.arange(C, device=dev)
    pos = torch.arange(n, device=dev)
    in_self = (pos >= self_lo) & (pos < self_hi)
    valid = torch.cat([valid_rx.reshape(-1), in_self])
    dest = torch.cat([(first[:, None] + k).reshape(-1), first[my] + pos - self_lo])
    invalid = (~valid).to(torch.int64)
    dest = torch.where(valid, dest, total + torch.cumsum(invalid, 0) - invalid)
    m = valid.numel()
    index = torch.empty(m, dtype=torch.int32, device=dev)
    index.index_copy_(0, dest, torch.arange(m, dtype=torch.int32, device=dev))
    return index, valid, total


def _psrs(shards: list, vals: list | None, *, form: _KeyForm, capacity: int,
          mesh: KeyMesh | None, reassembly: str = "sort"):
    """PSRS over this process's shards (1-D, in ``form``'s representation)
    and, for the key-value forms, their (n, W) payload rows.  Returns (sorted
    buffers, their payloads or None, valid counts as (1,) int64 tensors, the
    overflow count of the whole mesh on the first local rank's device)."""
    (P, first), n = global_ranks(mesh, len(shards)), shards[0].shape[0]
    order = "rank_chip" if vals is None else "chip_rank"

    # 1. local sort
    if vals is None:
        local = [(form.sort(x), None) for x in shards]
    else:
        local = [form.sort_kv(x, v) for x, v in zip(shards, vals)]
    search = [form.searchable(s) for s, _ in local]

    # 2. regular sampling on composites, 3. the send plans
    stride = max(n // P, 1)
    samples = all_gather([t[torch.arange(P, device=t.device) * stride] for t in search], mesh)
    plans = [_send_plan(t, _composite_splitters(g, stride, order), first + i, P, capacity, order)
             for i, (t, g) in enumerate(zip(search, samples))]
    del search, samples

    # the capacity-bounded exchange
    recv_k = all_to_all([_windows(s, b[:-1], capacity)
                         for (s, _), (b, _, _) in zip(local, plans)], mesh)
    recv_v = None
    if vals is not None:
        recv_v = all_to_all([_windows(v, b[:-1], capacity)
                             for (_, v), (b, _, _) in zip(local, plans)], mesh)
    counts_mat = all_gather([offdiag for _, offdiag, _ in plans], mesh)

    # 4. reassembly
    out_k, out_v, counts = [], [], []
    for i, ((s, sv), (b, _, _), rk, cm) in enumerate(zip(local, plans, recv_k, counts_mat)):
        my = first + i
        recv_count = cm[:, my]  # 0 at my own row: bypassed
        valid_rx = torch.arange(capacity, device=s.device)[None, :] < recv_count[:, None]
        self_lo, self_hi = b[my], b[my + 1]
        if vals is None:
            buf = _merge_buffer(rk, valid_rx, s, self_lo, self_hi, form.pad,
                                reassembly == "merge")
            if reassembly == "merge":
                out_k.append(merge_presorted(buf.view(KEY_DTYPE), capacity).view(torch.int32))
            else:
                out_k.append(form.sort(buf))
            counts.append((recv_count.sum() + (self_hi - self_lo)).view(1))
            continue
        index, valid, total = _kv_layout(valid_rx, recv_count, self_lo, self_hi, my, n)
        keys = torch.where(valid, torch.cat([rk.reshape(-1), s]), form.pad)
        mk, perm = form.sort_kv(keys.index_select(0, index), index)
        rows = torch.cat([recv_v[i].reshape(-1, *sv.shape[1:]), sv])
        out_k.append(mk)
        out_v.append(_gather_rows(rows, perm))
        counts.append(total.view(1))
    overflow = psum([ovf.to(torch.int32) for _, _, ovf in plans], mesh)
    return out_k, (out_v if vals is not None else None), counts, overflow


def _check_reassembly(reassembly: str) -> None:
    if reassembly not in _REASSEMBLIES:
        raise ValueError(f"reassembly must be 'sort' or 'merge', got {reassembly!r}")


def _check_shards(shards: list, mesh: KeyMesh, n_local: int, what: str) -> list:
    """This process's shards, one on each local rank's device."""
    shards = list(shards)
    if len(shards) != len(mesh.devices) or any(
            s.shape[0] != n_local or s.device != d for s, d in zip(shards, mesh.devices)):
        raise ValueError(f"expected {len(mesh.devices)} {what} shards of {n_local} rows on "
                         f"{mesh.devices}")
    return shards


def build_sample_sort(
    mesh: KeyMesh,
    n_local: int,
    *,
    capacity_factor: float = 1.5,
    axis: str = KEY_AXIS,
    reassembly: str = "sort",
):
    """The distributed sample sort of P shards of ``n_local`` uint32 keys.

    Returns ``(fn, capacity)``: ``fn(shards) -> (buffers, counts,
    overflow)``, ``shards`` a list of this process's 1-D uint32 tensors
    (shard r on ``mesh.devices[r]``; all P on a single controller),
    ``buffers`` each rank's sorted uint32 buffer of P * capacity + n_local
    keys, ``counts`` each rank's valid prefix length as a (1,) int64 tensor,
    ``overflow`` an int scalar on the first local rank's device (the ranks
    of the whole mesh whose off-diagonal sends overflowed ``capacity``).

    ``reassembly``: "sort" (one ``sort_full`` of the buffer) or "merge"
    (:func:`ops.merge_sort.merge_presorted` from L = capacity).  The JAX
    package's ``merge_b_out`` (the TPU merge levels' block) has no
    counterpart: B2's block is fixed."""
    _check_reassembly(reassembly)
    capacity = default_pair_capacity(n_local, mesh.shape[axis], capacity_factor)

    def fn(shards):
        shards = _check_shards(shards, mesh, n_local, "uint32")
        out, _, counts, overflow = _psrs(
            [s.view(torch.int32) for s in shards], None, form=_KEYS32,
            capacity=capacity, mesh=mesh, reassembly=reassembly)
        return [o.view(KEY_DTYPE) for o in out], counts, overflow

    return fn, capacity


def build_sample_sort_kv(
    mesh: KeyMesh,
    n_local: int,
    payload_lanes: int,
    *,
    capacity_factor: float = 1.5,
    axis: str = KEY_AXIS,
):
    """The distributed stable key-value sample sort.  Returns ``(fn,
    capacity)``: ``fn(keys, vals) -> (keys, vals, counts, overflow)`` with
    ``keys`` P 1-D uint32 shards and ``vals`` P (n_local, payload_lanes)
    uint32 shards; each rank's output holds P * capacity + n_local rows,
    its first ``counts[r]`` valid."""
    capacity = default_pair_capacity(n_local, mesh.shape[axis], capacity_factor)

    def fn(keys, vals):
        keys = _check_shards(keys, mesh, n_local, "uint32")
        vals = _check_shards(vals, mesh, n_local, "payload")
        if any(v.shape[1:] != (payload_lanes,) for v in vals):
            raise ValueError(f"payload shards must be (n_local, {payload_lanes})")
        out_k, out_v, counts, overflow = _psrs(
            [k.view(torch.int32) for k in keys], [v.view(torch.int32) for v in vals],
            form=_KEYS32, capacity=capacity, mesh=mesh)
        return ([k.view(KEY_DTYPE) for k in out_k], [v.view(KEY_DTYPE) for v in out_v],
                counts, overflow)

    return fn, capacity


def _joined(his: list, los: list) -> list:
    return [join_words(h, lo) for h, lo in zip(his, los)]


def build_sample_sort_64(
    mesh: KeyMesh,
    n_local: int,
    *,
    capacity_factor: float = 1.5,
    axis: str = KEY_AXIS,
):
    """The single-pass distributed sample sort of 64-bit keys held as the
    JAX package's (hi, lo) uint32 word lanes of the encoded words.  Returns
    ``(fn, capacity)``: ``fn(hi, lo) -> (hi, lo, counts, overflow)``."""
    capacity = default_pair_capacity(n_local, mesh.shape[axis], capacity_factor)

    def fn(hi, lo):
        hi = _check_shards(hi, mesh, n_local, "hi-word")
        lo = _check_shards(lo, mesh, n_local, "lo-word")
        out, _, counts, overflow = _psrs(_joined(hi, lo), None, form=_KEYS64,
                                         capacity=capacity, mesh=mesh)
        words = [split_words(o) for o in out]
        return [w[0] for w in words], [w[1] for w in words], counts, overflow

    return fn, capacity


def build_sample_sort_kv64(
    mesh: KeyMesh,
    n_local: int,
    payload_lanes: int,
    *,
    capacity_factor: float = 1.5,
    axis: str = KEY_AXIS,
):
    """The distributed stable key-value sample sort with 64-bit keys as
    (hi, lo) word lanes.  Returns ``(fn, capacity)``: ``fn(hi, lo, vals) ->
    (hi, lo, vals, counts, overflow)``."""
    capacity = default_pair_capacity(n_local, mesh.shape[axis], capacity_factor)

    def fn(hi, lo, vals):
        hi = _check_shards(hi, mesh, n_local, "hi-word")
        lo = _check_shards(lo, mesh, n_local, "lo-word")
        vals = _check_shards(vals, mesh, n_local, "payload")
        if any(v.shape[1:] != (payload_lanes,) for v in vals):
            raise ValueError(f"payload shards must be (n_local, {payload_lanes})")
        out_k, out_v, counts, overflow = _psrs(
            _joined(hi, lo), [v.view(torch.int32) for v in vals], form=_KEYS64,
            capacity=capacity, mesh=mesh)
        words = [split_words(o) for o in out_k]
        return ([w[0] for w in words], [w[1] for w in words],
                [v.view(KEY_DTYPE) for v in out_v], counts, overflow)

    return fn, capacity


# ---------------------------------------------------------------------------
# Host-facing entry points
# ---------------------------------------------------------------------------

def _pad_and_shard(x: torch.Tensor, mesh: KeyMesh, fill: int) -> tuple[list, int]:
    """``x`` (rows on its leading axis) padded with ``fill`` rows to the
    mesh, ``n_local = max(ceil(n / P), P)`` rows a rank (regular sampling
    takes P samples a shard), and sharded."""
    P, n = mesh.size, x.shape[0]
    n_local = max(-(-n // P), P)
    padded = torch.cat([x, x.new_full((n_local * P - n, *x.shape[1:]), fill)])
    if padded.dim() == 1:
        return shard(padded, mesh), n_local
    return [padded[r * n_local:(r + 1) * n_local].to(d)
            for r, d in enumerate(mesh.devices)], n_local


def _linearize(buffers: list, counts: list, n: int, n_local: int) -> list:
    """The valid prefixes of the ranks' buffers (each a list of tensors with
    rows on the leading axis), joined in rank order on the first rank's
    device, first n rows: one read of the counts from the device."""
    dev = counts[0].device
    sizes = torch.cat([c.to(dev) for c in counts]).tolist()
    assert sum(sizes) == n_local * len(sizes), (sizes, n_local)
    return [torch.cat([p[:c].to(parts[0].device) for p, c in zip(parts, sizes)])[:n]
            for parts in buffers]


def _payload(values, n: int) -> tuple[torch.Tensor, torch.dtype]:
    """The payload as (n, W) int32 lanes, and its dtype: (n, W) uint32, or
    (n, B) uint8 rows with B % 4 == 0 viewed as B/4 lanes (little-endian, as
    the JAX package's ``view(np.uint32)`` packs them)."""
    if not isinstance(values, torch.Tensor):
        values = torch.from_numpy(np.ascontiguousarray(values))
    if values.dim() == 0 or values.shape[0] != n:
        raise ValueError(f"values rows {values.shape[0] if values.dim() else None} != keys {n}")
    if values.dim() != 2 or values.dtype not in (torch.uint32, torch.uint8) or (
            values.dtype == torch.uint8 and values.shape[1] % 4):
        raise ValueError(_PAYLOAD_ERROR)
    return _dense(values).view(torch.int32), values.dtype


def _dense(x: torch.Tensor) -> torch.Tensor:
    """``x`` with unit strides, which a view as another element size needs
    (an empty tensor may have stride 0)."""
    return x.contiguous() if x.numel() else torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _unpayload(lanes: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Sorted int32 lanes back as (n, W) uint32 or (n, B) uint8 rows."""
    return _dense(lanes).view(dtype)


def _key_tensor(keys) -> torch.Tensor:
    """uint32 keys of a key-value sort: a uint32 tensor, or any array cast
    to uint32 as the JAX package's ``np.asarray(keys, dtype=np.uint32)``."""
    if isinstance(keys, torch.Tensor):
        if keys.dtype != KEY_DTYPE:
            raise TypeError(f"keys must be uint32, got {keys.dtype}")
        return keys.reshape(-1)
    return torch.from_numpy(np.asarray(keys, dtype=np.uint32).reshape(-1).copy())


def sort_distributed_sample(
    keys,
    *,
    mesh: KeyMesh | None = None,
    capacity_factor: float = 1.5,
    fallback: bool = True,
    reassembly: str = "sort",
) -> torch.Tensor:
    """Distributed sample sort: pads to the mesh, shards, runs PSRS and
    joins the ragged sorted shards, exactly; the sorted keys on the mesh's
    first device.  ``keys`` a numpy array or a tensor (uint32; int32 and
    float32 through the order-preserving codec).

    Composite splitters and the self bypass keep duplicates (all-equal,
    Zipf) and already-sorted input on this path.  Overflow takes
    adversarial placement -- a rank holding more than capacity keys bound
    for one other rank (reverse block-sorted input).  Then ``fallback=True``
    sorts through the exact gather exchange of the LSD sort, and
    ``fallback=False`` raises :class:`OverflowError_`.  On a process-group
    mesh it raises: call :func:`build_sample_sort`'s function in every
    process."""
    single_controller(mesh, "sort_distributed_sample", "build_sample_sort")
    keys = _as_keys(keys)
    if keys.dtype in (torch.int32, torch.float32):
        out = sort_distributed_sample(
            encode_ordered(keys), mesh=mesh, capacity_factor=capacity_factor,
            fallback=fallback, reassembly=reassembly,
        )
        return decode_ordered(out, keys.dtype)
    if keys.dtype != KEY_DTYPE:
        raise TypeError(f"unsupported key dtype {keys.dtype}; use uint32/int32/float32")
    _check_reassembly(reassembly)
    mesh = mesh or key_mesh()
    n = keys.numel()
    shards, n_local = _pad_and_shard(keys.view(torch.int32), mesh, PAD_KEY)
    fn, _ = build_sample_sort(mesh, n_local, capacity_factor=capacity_factor,
                              reassembly=reassembly)
    buffers, counts, overflow = fn([s.view(KEY_DTYPE) for s in shards])
    if int(overflow) > 0:
        if fallback:
            return sort_distributed(keys, mesh=mesh, exchange="gather")
        raise OverflowError_(
            "sample-sort pair capacity overflowed; increase capacity_factor "
            "or use the gather exchange for duplicate-heavy data"
        )
    (out,) = _linearize([buffers], counts, n, n_local)
    return out


def _sort_kv_tensors(keys: torch.Tensor, lanes: torch.Tensor, mesh: KeyMesh | None,
                     capacity_factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The kv sample sort of uint32 keys and (n, W) int32 lanes; raises
    :class:`OverflowError_` on overflow."""
    mesh = mesh or key_mesh()
    n, W = keys.numel(), lanes.shape[1]
    key_shards, n_local = _pad_and_shard(keys.view(torch.int32), mesh, PAD_KEY)
    val_shards, _ = _pad_and_shard(lanes, mesh, 0)
    fn, _ = build_sample_sort_kv(mesh, n_local, W, capacity_factor=capacity_factor)
    mk, mv, counts, overflow = fn([k.view(KEY_DTYPE) for k in key_shards],
                                  [v.view(KEY_DTYPE) for v in val_shards])
    if int(overflow) > 0:
        raise OverflowError_("kv sample-sort capacity overflowed; increase capacity_factor")
    out_k, out_v = _linearize([mk, mv], counts, n, n_local)
    return out_k, out_v.view(torch.int32)


def sort_key_value_distributed(
    keys,
    values,
    *,
    mesh: KeyMesh | None = None,
    capacity_factor: float = 1.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Distributed stable key-value sort: the sorted uint32 keys and the
    payload rows in their order, equal to a stable single-device key-value
    sort, on the mesh's first device.  ``values``: (n, W) uint32 or (n, B)
    uint8 rows with B % 4 == 0, returned in their dtype.  Raises
    :class:`OverflowError_` where the exchange overflows, and ValueError on a
    process-group mesh (call :func:`build_sample_sort_kv`'s function in
    every process)."""
    single_controller(mesh, "sort_key_value_distributed", "build_sample_sort_kv")
    keys = _key_tensor(keys)
    lanes, dtype = _payload(values, keys.numel())
    out_k, out_v = _sort_kv_tensors(keys, lanes, mesh, capacity_factor)
    return out_k, _unpayload(out_v, dtype)


def _keys64(keys, what: str) -> torch.Tensor:
    if not isinstance(keys, torch.Tensor):
        keys = torch.from_numpy(np.ascontiguousarray(keys))
    if keys.dtype not in KEY64_DTYPES:
        raise TypeError(f"{what} takes uint64/int64/float64 keys, got {keys.dtype}")
    return keys.reshape(-1)


def _single_pass64(enc: torch.Tensor, lanes: torch.Tensor | None, mesh: KeyMesh,
                   capacity_factor: float):
    """The single-pass PSRS of sortable int64 keys (and int32 lanes): the
    joined (keys, lanes or None), or None where the exchange overflowed."""
    n = enc.numel()
    shards, n_local = _pad_and_shard(enc, mesh, PAD_KEY64)
    capacity = default_pair_capacity(n_local, mesh.size, capacity_factor)
    val_shards = None if lanes is None else _pad_and_shard(lanes, mesh, 0)[0]
    out_k, out_v, counts, overflow = _psrs(shards, val_shards, form=_KEYS64,
                                           capacity=capacity, mesh=mesh)
    if int(overflow) > 0:
        return None
    if lanes is None:
        return _linearize([out_k], counts, n, n_local)[0], None
    return tuple(_linearize([out_k, out_v], counts, n, n_local))


def sort_key_value_distributed_64(
    keys,
    values,
    *,
    mesh: KeyMesh | None = None,
    capacity_factor: float = 1.5,
    single_pass: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Distributed stable key-value sort with 64-bit keys (uint64 / int64 /
    float64 in IEEE-754 totalOrder), the key-value twin of
    :func:`sort_distributed_64`; ``values`` as in
    :func:`sort_key_value_distributed`.  One stable key-value PSRS of the
    keys; ``single_pass=False`` (and an overflow) composes two stable
    32-bit key-value sample sorts instead: by the lo word carrying the hi
    word and the payload, then by the hi word carrying the lo word.  On a
    process-group mesh it raises: call :func:`build_sample_sort_kv64`'s
    function in every process."""
    single_controller(mesh, "sort_key_value_distributed_64", "build_sample_sort_kv64")
    keys = _keys64(keys, "sort_key_value_distributed_64")
    lanes, dtype = _payload(values, keys.numel())
    enc = encode_ordered64(keys)
    got = None
    if single_pass:
        got = _single_pass64(enc, lanes, mesh or key_mesh(), capacity_factor)
    if got is None:
        hi, lo = split_words(enc)
        cols = torch.cat([hi.view(torch.int32)[:, None].to(lanes.device), lanes], dim=1)
        slo, v1 = _sort_kv_tensors(lo, cols, mesh, capacity_factor)
        cols = torch.cat([slo.view(torch.int32)[:, None], v1[:, 1:]], dim=1)
        shi, v2 = _sort_kv_tensors(v1[:, 0].contiguous().view(KEY_DTYPE), cols, mesh,
                                   capacity_factor)
        got = join_words(shi, v2[:, 0].contiguous().view(KEY_DTYPE)), v2[:, 1:]
    out_k, out_v = got
    return decode_ordered64(out_k, keys.dtype), _unpayload(out_v, dtype)


def sort_distributed_64(
    keys,
    *,
    mesh: KeyMesh | None = None,
    capacity_factor: float = 1.5,
    single_pass: bool = True,
) -> torch.Tensor:
    """Distributed full sort of 64-bit keys (uint64 / int64 / float64, the
    float64 order IEEE-754 totalOrder), returned in the keys' dtype on the
    mesh's first device.  One keys-only PSRS of the sortable int64 words;
    ``single_pass=False`` (and an overflow) runs the LSD composition of two
    stable 32-bit key-value sample sorts instead (by the lo word carrying
    the hi word, then by the hi word carrying the lo word).  On a
    process-group mesh it raises: call :func:`build_sample_sort_64`'s
    function in every process."""
    single_controller(mesh, "sort_distributed_64", "build_sample_sort_64")
    keys = _keys64(keys, "sort_distributed_64")
    enc = encode_ordered64(keys)
    got = None
    if single_pass:
        got = _single_pass64(enc, None, mesh or key_mesh(), capacity_factor)
    if got is not None:
        return decode_ordered64(got[0], keys.dtype)
    hi, lo = split_words(enc)
    slo, shi = _sort_kv_tensors(lo, hi.view(torch.int32)[:, None], mesh, capacity_factor)
    shi2, slo2 = _sort_kv_tensors(shi.reshape(-1).view(KEY_DTYPE), slo.view(torch.int32)[:, None],
                                  mesh, capacity_factor)
    return decode_ordered64(join_words(shi2, slo2.reshape(-1).view(KEY_DTYPE)), keys.dtype)
