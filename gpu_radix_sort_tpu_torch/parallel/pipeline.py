"""Distributed hash-partition -> filter -> aggregate (skew-aware group-by).

Port of ``gpu_radix_sort_tpu/parallel/pipeline.py`` onto the mesh of
:mod:`.mesh`, a single controller or a process group (BASELINE.json config
5).  Phases, each a loop over this process's ranks:

  1. **Filter, hash order and local combine.**  The JAX package sorts
     (dropped, hash, key, value) stably.  The hash is a bijection, so equal
     hashes are equal keys, and that order is: the valid rows packed to the
     front in input order, then stably sorted by hash alone.  Keys only
     (``op="count"``), one ``sort_full`` of the hashes with the dropped rows
     set to ``HASH_PAD`` (B1 and B2, or B3 at <= 2^14 keys), the keys
     recovered by the inverse hash: the first ``kept`` words of the sorted
     multiset are the valid rows' hashes even where a valid key hashes to
     ``HASH_PAD``, as those words are identical.  With values, the valid
     rows are packed (``ops.table.pack_by_mask``) and one stable
     ``sort_key_value`` of the hashes carries them (B5 passes), so a float
     group adds in the JAX package's order.  Then ``group_aggregate_sorted``:
     a Zipf hot key becomes one row a rank before anything moves.
  2. **Splitters** over the hash order: P regular samples of each rank's
     valid prefix, gathered and sorted; every P-th of the P*P candidates
     splits.  Searched in the sign-flipped int32 domain (torch has no
     uint32 ``searchsorted``).
  3. **Exchange**: capacity-bounded send windows padded with the identity,
     the (P, P) count matrix by ``all_gather``, keys and aggregates by
     ``all_to_all``.  Overflow is counted, never silent.
  4. **Final merge**: the valid received rows packed in (source, slot)
     order, the rest keyed 0xFFFFFFFF, one stable ``sort_key_value`` by key
     with the aggregates riding (B5), then the combine; each rank's groups
     come out in key order.  The JAX package sorts (invalid, key) stably:
     the same valid rows in the same order.

Validity is tracked by packing (valid rows first and a count), never by a
sentinel key, so full-range keys, 0xFFFFFFFF included, are exact.  Padding
rows are rewritten as the JAX package rewrites them (the last valid key or
``keys[0]``, with the identity), which fixes bytes too: a float group
summing to -0.0, extended by a +0.0 identity row, reads +0.0.

Nothing inside the function :func:`build_hash_aggregate` returns waits on
the host; :func:`hash_aggregate_distributed` reads the device once after it.
Each phase is a span for the profiler (``utils/timers.span``): the whole
function is ``grs.aggregate``; inside it, a rank's filter and hash order is
``grs.aggregate.hash_order``, each combine ``grs.aggregate.combine`` (two a
rank: the local one and the final one), the splitters and the exchange
``grs.aggregate.splitters`` and ``grs.aggregate.exchange`` once a call,
and a rank's final pack and key-value sort ``grs.aggregate.merge``.  The
spans of ``sort_full`` and of the binning passes nest inside them.
The JAX package's program cache (``_cached_hash_aggregate``) has no
counterpart: it avoided recompiles of its jitted program, and nothing here
compiles.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bits import KEY_DTYPE, raw_view, to_int64
from ..ops.radix_sort import sort_full, sort_key_value
from ..ops.table import VALID_AGG_OPS, _unhash_u32, group_aggregate_sorted, hash_u32, pack_by_mask
from ..utils.timers import span
from .distributed import OverflowError_
from .exchange import default_capacity, send_windows
from .mesh import (
    KEY_AXIS, KeyMesh, all_gather, all_to_all, global_ranks, key_mesh, psum, single_controller,
)
from .sample_sort import _check_shards, _key_tensor, _pad_and_shard

HASH_PAD = 0xFFFFFFFF  # the largest hash: dropped rows sort after every valid one
_PAD_WORD = HASH_PAD - (1 << 32)  # HASH_PAD (and the largest key) as an int32 word
_PAD_FLIPPED = HASH_PAD - (1 << 31)  # HASH_PAD in the sign-flipped int32 domain
_INT32_MIN = -(1 << 31)

# Group counts from which key_order=True sorts on the mesh's first device
# (sort_key_value, B5 passes) instead of by np.argsort on the host.  On an
# H100 (chip_smoke.py's aggregate path) the card's route takes ~4.5-6 ms
# whatever the count, np.argsort ~25 ns a group: the card wins from 2^18.
KEY_ORDER_DEVICE_MIN = 1 << 18


def _identity_bits(op: str, dtype: torch.dtype) -> int:
    """The aggregation identity of ``op`` in ``dtype``, as the bits of
    ``raw_view``'s signed integer type: 0 for sum and count, the type's
    largest value for min and its lowest for max."""
    if op in ("sum", "count"):
        return 0
    info = torch.finfo(dtype) if dtype.is_floating_point else torch.iinfo(dtype)
    value = torch.tensor(info.max if op == "min" else info.min, dtype=dtype)
    return raw_view(value).item()


def _positions(n: int, device) -> torch.Tensor:
    """0 ... n-1, in int32 where it holds them (half the bytes of int64)."""
    return torch.arange(n, dtype=torch.int32 if n < 1 << 31 else torch.int64, device=device)


def _neutralize_tail(keys: torch.Tensor, vals: torch.Tensor, count: torch.Tensor, op: str):
    """Rows at index >= count rewritten to (keys[0], identity): they merge
    into an existing group (when count > 0) contributing nothing."""
    valid = _positions(keys.shape[0], keys.device) < count
    k = torch.where(valid, keys.view(torch.int32), keys.view(torch.int32)[:1])
    v = torch.where(valid, raw_view(vals), _identity_bits(op, vals.dtype))
    return k.view(KEY_DTYPE), v.view(vals.dtype)


def _combine_sorted(keys: torch.Tensor, values: torch.Tensor, kept: torch.Tensor,
                    merge_op: str):
    """Group-aggregate over a key-sorted valid prefix of ``kept`` rows: the
    rows past it are rewritten to the last valid key with the identity, so
    that they extend the last group (``_neutralize_tail``'s keys[0] would
    start a group out of order).  Returns (uniq, agg, ngroups)."""
    valid = _positions(keys.shape[0], keys.device) < kept
    k = keys.view(torch.int32)
    last = k.index_select(0, (kept.to(torch.int64) - 1).clamp(min=0).view(1))
    k = torch.where(valid, k, last)
    v = torch.where(valid, raw_view(values), _identity_bits(merge_op, values.dtype))
    uniq, agg, ng = group_aggregate_sorted(k.view(KEY_DTYPE), v.view(values.dtype), merge_op)
    return uniq, agg, torch.where(kept > 0, ng, 0)


def _hash_order(keys: torch.Tensor, values: torch.Tensor | None, mask: torch.Tensor):
    """(keys, values, kept): the rows where ``mask`` holds first, in (hash,
    input) order, as the JAX package's stable sort by (dropped, hash, key)
    leaves them; ``values=None`` sorts keys alone.  Rows past ``kept`` are
    left over."""
    if values is None:
        h = torch.where(mask, hash_u32(keys).view(torch.int32), _PAD_WORD)
        keys = _unhash_u32(sort_full(h.view(KEY_DTYPE)))
        return keys, None, mask.sum(dtype=torch.int32)
    keys, values, kept = pack_by_mask(mask, keys, values)
    tail = _positions(keys.shape[0], keys.device) >= kept
    h = torch.where(tail, _PAD_WORD, hash_u32(keys).view(torch.int32))
    sorted_h, values = sort_key_value(h.view(KEY_DTYPE), values)
    return _unhash_u32(sorted_h), values, kept


def _flipped_hashes(uniq: torch.Tensor, ng: torch.Tensor) -> torch.Tensor:
    """The combined rows' hashes in the sign-flipped int32 domain (ascending
    as uint32 hashes are), ``HASH_PAD`` at and past ``ng``."""
    pos = _positions(uniq.shape[0], uniq.device)
    return torch.where(pos < ng, hash_u32(uniq).view(torch.int32) ^ _INT32_MIN, _PAD_FLIPPED)


def _samples(hf: torch.Tensor, ng: torch.Tensor, P: int) -> torch.Tensor:
    """P regular samples of the valid prefix, at positions i * ng // P in
    the JAX package's form, which never forms i * ng (it overflowed int32 at
    pod scale there); all ``HASH_PAD`` when the rank holds no group."""
    ngc = ng.to(torch.int64).clamp(min=1)
    i = torch.arange(P, device=hf.device)
    pos = i * (ngc // P) + (i * (ngc % P)) // P
    return torch.where(ng > 0, hf[pos], _PAD_FLIPPED)


def _send_bounds(hf: torch.Tensor, ng: torch.Tensor, gathered: torch.Tensor) -> torch.Tensor:
    """Each peer's slice [b[c], b[c+1]) of the combined rows: the splitters
    are every P-th of the sorted P*P candidates, searched in ``hf`` and
    clipped to the valid prefix.  int64 (P+1,)."""
    P = gathered.shape[0]
    cand = torch.sort(gathered.reshape(-1)).values
    splitters = cand[torch.arange(1, P, device=hf.device) * P]
    ng64 = ng.to(torch.int64).view(1)
    bounds = torch.minimum(torch.searchsorted(hf, splitters, side="left"), ng64)
    return torch.cat([ng64.new_zeros(1), bounds, ng64])


def _padded_windows(x: torch.Tensor, starts: torch.Tensor, capacity: int, fill: int):
    """Rows ``x[starts[c] : starts[c] + capacity]`` for each peer c, as
    (P, capacity) words of ``raw_view``'s type, the buffer padded with the
    bits ``fill`` past its end."""
    raw = raw_view(x)
    return send_windows(torch.cat([raw, raw.new_full((capacity,), fill)]), starts, capacity)


def _pipeline(keys: list, values: list, row_valid: list, *, capacity: int, op: str,
              predicate, mesh: KeyMesh | None):
    """The hash aggregate over this process's shards.  Returns per-rank
    (group keys, aggregates) buffers of P * capacity rows, per-rank group
    counts as (1,) int32 tensors, and the overflow count of the whole mesh
    on the first local rank's device."""
    P, first = global_ranks(mesh, len(keys))
    merge_op = "sum" if op == "count" else op

    # 1. filter, hash order, local combine
    combined = []
    for k, v, m in zip(keys, values, row_valid):
        with span("grs.aggregate.hash_order"):
            mask = m.to(torch.bool)
            if predicate is not None:
                mask = mask & predicate(to_int64(k))
            sk, sv, kept = _hash_order(k, None if op == "count" else v, mask)
        with span("grs.aggregate.combine"):
            if sv is None:  # count: a sum of ones, so that padding rows carry 0
                sv = torch.ones(sk.shape[0], dtype=torch.int32, device=sk.device).view(KEY_DTYPE)
            uniq, agg, ng = _combine_sorted(sk, sv, kept, merge_op)
            uniq, agg = _neutralize_tail(uniq, agg, ng, merge_op)
        combined.append((uniq, agg, ng))

    # 2. splitters over the hash order
    with span("grs.aggregate.splitters"):
        hashes = [_flipped_hashes(uniq, ng) for uniq, _, ng in combined]
        gathered = all_gather([_samples(hf, ng, P) for hf, (_, _, ng) in zip(hashes, combined)],
                              mesh)
        bounds = [_send_bounds(hf, ng, g)
                  for hf, (_, _, ng), g in zip(hashes, combined, gathered)]
        del hashes, gathered

    # 3. the capacity-bounded exchange
    with span("grs.aggregate.exchange"):
        send_count = [b[1:] - b[:-1] for b in bounds]
        overflow = psum([(c > capacity).any().to(torch.int32) for c in send_count], mesh)
        recv_k = all_to_all([_padded_windows(uniq, b[:-1], capacity, 0)
                             for (uniq, _, _), b in zip(combined, bounds)], mesh)
        recv_a = all_to_all([_padded_windows(agg, b[:-1], capacity,
                                             _identity_bits(merge_op, agg.dtype))
                             for (_, agg, _), b in zip(combined, bounds)], mesh)
        counts_mat = all_gather(send_count, mesh)
        agg_dtype = combined[0][1].dtype
        del combined, bounds

    # 4. final merge
    out_k, out_a, ngroups = [], [], []
    for i, (rk, ra, cm) in enumerate(zip(recv_k, recv_a, counts_mat)):
        with span("grs.aggregate.merge"):
            valid = (_positions(capacity, rk.device)[None, :] < cm[:, first + i, None]).reshape(-1)
            pk, pa, total = pack_by_mask(valid, rk.reshape(-1), ra.reshape(-1))
            tail = _positions(pk.shape[0], pk.device) >= total
            pk = torch.where(tail, _PAD_WORD, pk).view(KEY_DTYPE)
            sk, sa = sort_key_value(pk, pa.view(agg_dtype))
        with span("grs.aggregate.combine"):
            uniq, agg, ng = _combine_sorted(sk, sa, total, merge_op)
        out_k.append(uniq)
        out_a.append(agg)
        ngroups.append(ng.to(torch.int32).view(1))
    return out_k, out_a, ngroups, overflow


def build_hash_aggregate(
    mesh: KeyMesh,
    n_local: int,
    *,
    op: str = "sum",
    predicate=None,
    capacity_factor: float = 2.0,
    axis: str = KEY_AXIS,
):
    """The distributed group-by of P shards of ``n_local`` rows.

    Returns ``(fn, capacity)``: ``fn(keys, values, row_valid) ->
    (group_keys, aggregates, ngroups, overflow)``, each input a list of this
    process's 1-D tensors of ``n_local`` rows (shard r on
    ``mesh.devices[r]``; all P on a single controller): uint32 keys, values
    (ignored for ``op="count"``: pass the keys), and bool ``row_valid``
    (rows marked False never contribute).  Each rank returns P * capacity
    rows of group keys and aggregates, its first ``ngroups[r]`` valid ((1,)
    int32), and ``overflow`` is an int scalar on the first local rank's
    device (the ranks of the whole mesh whose sends overflowed).

    ``predicate`` filters the rows: a callable on a rank's keys, given as
    int64 values 0 ... 2^32 - 1 on the rank's device (torch has no uint32
    bitwise operations or comparisons), returning a bool tensor."""
    if op not in VALID_AGG_OPS:
        raise ValueError(f"op must be one of {VALID_AGG_OPS}, got {op!r}")
    capacity = default_capacity(n_local, mesh.shape[axis], capacity_factor)

    def fn(keys, values, row_valid):
        with span("grs.aggregate"):
            keys = _check_shards(keys, mesh, n_local, "uint32 key")
            values = _check_shards(values, mesh, n_local, "value")
            row_valid = _check_shards(row_valid, mesh, n_local, "row_valid")
            return _pipeline(keys, values, row_valid, capacity=capacity, op=op,
                             predicate=predicate, mesh=mesh)

    return fn, capacity


def _key_order_host(keys: torch.Tensor, aggs: torch.Tensor):
    k, a = keys.cpu().numpy(), aggs.cpu().numpy()
    order = np.argsort(k)
    return k[order], a[order]


def _key_order_device(keys: torch.Tensor, aggs: torch.Tensor):
    k, a = sort_key_value(keys, aggs)
    return k.cpu().numpy(), a.cpu().numpy()


def hash_aggregate_distributed(
    keys,
    values=None,
    *,
    op: str = "sum",
    predicate=None,
    mesh: KeyMesh | None = None,
    capacity_factor: float = 2.0,
    key_order: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-facing distributed group-by over the mesh (default: every CUDA
    device): returns numpy (group_keys, aggregates) joined in rank order --
    in hash order within each rank by default, or in ascending key order
    with ``key_order=True`` (one sort over the distinct keys only, as
    ``np.unique`` presents them: on the mesh's first device from
    ``KEY_ORDER_DEVICE_MIN`` groups, by ``np.argsort`` below).  ``keys`` a
    numpy array (cast to uint32) or a uint32 tensor, ``values`` 1-D of the
    same length (required unless ``op="count"``); ``predicate`` as in
    :func:`build_hash_aggregate`.  Raises :class:`OverflowError_` where the
    exchange overflows, and ValueError on a process-group mesh (call
    :func:`build_hash_aggregate`'s function in every process)."""
    single_controller(mesh, "hash_aggregate_distributed", "build_hash_aggregate")
    mesh = mesh or key_mesh()
    keys = _key_tensor(keys)
    n = keys.numel()
    if values is None:
        if op != "count":
            raise ValueError("values required unless op='count'")
        values = keys  # ignored for count
    elif not isinstance(values, torch.Tensor):
        values = torch.from_numpy(np.ascontiguousarray(values))
    if values.dim() != 1 or values.numel() != n:
        raise ValueError(f"values must be 1-D with {n} rows, got shape {tuple(values.shape)}")
    dev = mesh.devices[0]
    key_shards, n_local = _pad_and_shard(keys.to(dev).view(torch.int32), mesh, 0)
    val_shards, _ = _pad_and_shard(raw_view(values.contiguous().to(dev)), mesh, 0)
    row_valid = [torch.arange(r * n_local, (r + 1) * n_local, device=d) < n
                 for r, d in enumerate(mesh.devices)]
    fn, _ = build_hash_aggregate(mesh, n_local, op=op, predicate=predicate,
                                 capacity_factor=capacity_factor)
    gk, ga, ngroups, overflow = fn([s.view(KEY_DTYPE) for s in key_shards],
                                   [s.view(values.dtype) for s in val_shards], row_valid)
    # one read of the device: the overflow count, then each rank's groups
    head = torch.cat([overflow.view(1).to(dev, torch.int64),
                      *(g.to(dev, torch.int64) for g in ngroups)]).tolist()
    if head[0] > 0:
        raise OverflowError_("hash-aggregate exchange capacity overflowed; raise capacity_factor")
    out_k = torch.cat([raw_view(k[:c]).to(dev) for k, c in zip(gk, head[1:])]).view(KEY_DTYPE)
    out_a = torch.cat([raw_view(a[:c]).to(dev) for a, c in zip(ga, head[1:])]).view(ga[0].dtype)
    if key_order and out_k.numel():
        if out_k.numel() >= KEY_ORDER_DEVICE_MIN:
            return _key_order_device(out_k, out_a)
        return _key_order_host(out_k, out_a)
    return out_k.cpu().numpy(), out_a.cpu().numpy()
