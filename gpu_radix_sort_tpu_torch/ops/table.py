"""Table operators: hash partition, filter (compaction), group aggregate.

Port of ``gpu_radix_sort_tpu/ops/table.py``, the relational steps the
distributed design composes with (hash-partition -> filter -> aggregate).
Shapes stay static as in the JAX package: a filter returns the packed rows
and their count, and the rows past the count are left over, not cut off.

What moves the data here:
  * ``partition_by_ids`` is a stable digit sort by the partition ids with
    the keys as its column (``sort_key_value_by_digits``: binning passes);
  * ``group_aggregate`` sorts by ``sort_key_value`` (binning passes) or,
    keys only, by ``sort_full``;
  * packing by a mask is a stable compaction: an exclusive ``cumsum`` of
    the mask gives each row its place, and one ``index_copy_`` moves it (the
    JAX package sorts there, as a sort was its fast permutation on the TPU);
  * integer sums are ``cumsum`` differences (exact mod 2^bits), min and max
    a segmented scan (a running max over (segment, value) pairs).

Float sums keep the reference's order where it is defined: on a CPU tensor
each segment is added serially in index order from 0.0 (``index_add_``, as
XLA's CPU scatter-add behind ``segment_sum`` does), so the bytes equal the
JAX package's.  On a CUDA tensor ``index_add_`` adds by atomics in no fixed
order; there :func:`segment_sum_scan` adds in a fixed tree order instead,
the same bytes on every call.  float32 min and max give the JAX package's
bytes on NaNs and signed zeros (:func:`_float_nan_and_zero`).

One exception to equal bytes, on every device: XLA on the CPU (as on the
TPU) flushes float32 subnormals to zero in group sum, min and max, and the
port keeps them, as CUDA does; there the port agrees with numpy instead.
"""

from __future__ import annotations

import torch

from .bits import (
    KEY_DTYPE, RAW_DTYPES, as_tensor, decode_ordered, encode_ordered, from_int64,
    raw_view, to_int64,
)
from .radix_sort import sort_full, sort_key_value, sort_key_value_by_digits
from .boundaries import digit_counts_sorted

# Fibonacci multiplicative hashing: an odd constant ~ 2^32/phi, bijective on
# uint32, then an xor-shift round (gpu_radix_sort_tpu/ops/table.py:28-41).
_HASH_MULT = 2654435769
_HASH_MULT2 = 0x2C1B3C6D
_MASK32 = 0xFFFFFFFF
# their inverses mod 2^32, for undoing the hash
_HASH_MULT_INV = 0x144CBC89
_HASH_MULT2_INV = 0x64EA2D65

VALID_AGG_OPS = ("sum", "count", "min", "max")


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor ``x`` as uint32 (its low 32 bits, as ``astype``)."""
    if x.dtype == KEY_DTYPE:
        return x
    if x.dtype == torch.int32:
        return x.view(KEY_DTYPE)
    if x.is_floating_point() or x.is_complex():
        raise TypeError(f"expected integer keys, got {x.dtype}")
    return from_int64(x.to(torch.int64) & _MASK32)


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32), in two 16-bit halves so
    that no int64 product overflows."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _MASK32


def _hash64(keys: torch.Tensor) -> torch.Tensor:
    x = _mul32(to_int64(_u32(keys)), _HASH_MULT)
    x = x ^ (x >> 15)
    x = _mul32(x, _HASH_MULT2)
    return x ^ (x >> 12)


def hash_u32(keys) -> torch.Tensor:
    """Deterministic uint32 -> uint32 hash (bijective), bit-exact with the
    JAX package's uint32 arithmetic."""
    return from_int64(_hash64(as_tensor(keys)))


def _unxorshift(x: torch.Tensor, s: int) -> torch.Tensor:
    """The y with y ^ (y >> s) == x, for int64 x in [0, 2^32)."""
    y, shift = x, s
    while shift < 32:
        y = y ^ (x >> shift)
        shift += s
    return y


def _unhash_u32(hashes: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`hash_u32`: the uint32 keys whose hashes are
    ``hashes`` (uint32), so that a sort of hashes alone gives back its keys."""
    x = _mul32(_unxorshift(to_int64(_u32(hashes)), 12), _HASH_MULT2_INV)
    return from_int64(_mul32(_unxorshift(x, 15), _HASH_MULT_INV))


def hash_partition_ids(keys, nparts: int) -> torch.Tensor:
    """Radix hash partition: the partition id (uint32) is the top
    log2(nparts) bits of the hash, uniform for any key distribution, and
    duplicates land together."""
    if nparts < 1 or nparts & (nparts - 1):
        raise ValueError(f"nparts must be a power of 2 >= 1, got {nparts}")
    keys = as_tensor(keys)
    if nparts == 1:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device).view(KEY_DTYPE)
    return from_int64(_hash64(keys) >> (32 - (nparts.bit_length() - 1)))


def partition_by_ids(
    keys, part_ids, nparts: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable-partition keys by partition id (each in [0, nparts)); returns
    (reordered keys, counts int32[nparts]).  Run r of the output (its start
    the exclusive cumsum of the counts) is partition r, in input order."""
    if nparts < 1:
        raise ValueError(f"nparts must be >= 1, got {nparts}")
    keys, ids = as_tensor(keys), _u32(as_tensor(part_ids))
    if nparts == 1:  # a digit of width 0: nothing to sort by
        return raw_view(keys).clone().view(keys.dtype), torch.full(
            (1,), keys.shape[0], dtype=torch.int32, device=keys.device)
    width = (nparts - 1).bit_length()
    sorted_ids, reordered = sort_key_value_by_digits(ids, keys, 0, width)
    return reordered, digit_counts_sorted(sorted_ids, 0, width)[:nparts]


def pack_by_mask(mask, *arrays):
    """Stable-pack the rows where ``mask`` is True to the front of every
    array at once (one permutation, so the arrays stay row-aligned); the
    other rows follow in their order.  Returns (packed arrays..., count as
    an int32 scalar tensor)."""
    mask = as_tensor(mask).to(torch.bool)
    n = mask.shape[0]
    kept = torch.cumsum(mask, 0, dtype=torch.int64)  # inclusive
    count = kept[-1] if n else torch.zeros((), dtype=torch.int64, device=mask.device)
    pos = torch.arange(n, dtype=torch.int64, device=mask.device)
    dest = torch.where(mask, kept - 1, count + pos - kept)
    del kept, pos
    packed = []
    for a in map(as_tensor, arrays):
        raw = raw_view(a.contiguous())
        packed.append(torch.empty_like(raw).index_copy_(0, dest, raw).view(a.dtype))
    return (*packed, count.to(torch.int32))


def compact(values, mask) -> tuple[torch.Tensor, torch.Tensor]:
    """Filter with static shapes: the elements where ``mask`` is True packed
    to the front in order, and their count.  Elements past the count are
    unspecified."""
    return pack_by_mask(mask, values)


def filter_range(keys, lo: int, hi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """uint32 keys in [lo, hi), packed, and their count."""
    k = _u32(as_tensor(keys))
    k64 = to_int64(k)
    return compact(k, (k64 >= lo) & (k64 < hi))


CUMMAX_ROW = 1 << 12  # elements a row of the two-level running max


def _cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of 1-D integer ``x``, in two levels: rows of
    CUMMAX_ROW elements each scanned by ``cummax``, then each row raised to
    the running max of the rows before it.  (A 1-D ``cummax`` runs in one
    CUDA block: over 2^28 rows it held the float32 group sum at ~1 s on an
    H100, against ~0.2 s in two levels.)"""
    n = x.numel()
    rows = -(-n // CUMMAX_ROW)
    padded = torch.full((rows * CUMMAX_ROW,), torch.iinfo(x.dtype).min, dtype=x.dtype,
                        device=x.device)
    padded[:n] = x
    scan = padded.view(rows, CUMMAX_ROW).cummax(1).values
    carry = scan[:, -1].cummax(0).values
    scan[1:] = torch.maximum(scan[1:], carry[:-1, None])
    return scan.view(-1)[:n]


def segment_sum_scan(values: torch.Tensor, is_start: torch.Tensor) -> torch.Tensor:
    """Float sums of the runs that ``is_start`` opens, added in a fixed
    order whatever the device: a log-step segmented inclusive scan
    (Hillis-Steele: in step d each row adds the row d before it when that
    lies in its run), read at each run's last row.  Returns the sums in run
    order, 0 past the last run.  Rounding differs from a serial sum (it is
    a tree of depth log2 of the longest run), but it is the same on every
    call: no op here adds in an order that varies (no atomics)."""
    n = values.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=values.device)
    # distance of each row from the start of its run
    dist = pos - _cummax(torch.where(is_start, pos, 0))
    longest = int(dist.max()) + 1 if n else 0
    y = values.clone()
    d = 1
    while d < longest:
        y[d:] += torch.where(dist[d:] >= d, y[:-d], 0)
        d *= 2
    is_end = torch.cat([is_start[1:], is_start.new_ones(1)])
    sums, count = pack_by_mask(is_end, y)
    return torch.where(pos < count, sums, 0)


def _segment_sum(values: torch.Tensor, is_start: torch.Tensor) -> torch.Tensor:
    """Float sums of the runs that ``is_start`` opens, in run order, 0 past
    the last run: serial on the CPU, :func:`segment_sum_scan` on CUDA."""
    if values.device.type != "cpu":
        return segment_sum_scan(values, is_start)
    seg = torch.cumsum(is_start, 0, dtype=torch.int64) - 1
    return torch.zeros_like(values).index_add_(0, seg, values)


def _wrap(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 ``x`` modulo 2^bits of the integer ``dtype``, in that dtype
    (what a cumsum and its differences in ``dtype`` give)."""
    if dtype.itemsize == 8:
        return x.view(dtype)
    return x.to(RAW_DTYPES[dtype.itemsize]).view(dtype)


def _as_int64(v: torch.Tensor) -> torch.Tensor:
    if v.dtype == KEY_DTYPE:
        return to_int64(v)
    if v.dtype.itemsize == 8:
        return v.view(torch.int64)
    return v.to(torch.int64)


def _order_key(v: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) whose order is the order of values ``v`` of at
    most 4 bytes (float32 in IEEE-754 totalOrder)."""
    if v.dtype == torch.float32:
        return to_int64(encode_ordered(v))
    if v.dtype == KEY_DTYPE:
        return to_int64(v)
    if v.is_floating_point() or v.is_complex() or v.dtype.itemsize > 4:
        raise TypeError(
            f"min and max take integer or float32 values of at most 4 bytes, "
            f"got {v.dtype}"
        )
    return v.to(torch.int64) + (1 << 31)


def _from_order_key(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return decode_ordered(from_int64(key), torch.float32)
    if dtype == KEY_DTYPE:
        return from_int64(key)
    return (key - (1 << 31)).to(dtype)


_QUIET_BIT = 1 << 22  # the float32 mantissa bit that makes a NaN quiet


def _float_nan_and_zero(values: torch.Tensor, seg: torch.Tensor,
                        scanned: torch.Tensor, op: str) -> torch.Tensor:
    """float32 prefix mins or maxes ``scanned`` made the JAX package's bytes
    (``jnp.minimum``/``jnp.maximum`` in an associative scan, as XLA runs it
    on the CPU): a prefix holding a NaN gives a NaN, and among its NaNs
    min takes the first positive one, else the last negative one, max the
    first negative one, else the last positive one, with its quiet bit set;
    a zero result is +0.0.  One element alone is returned as it is.  Bit
    operations only, so a CUDA tensor gives the same bytes.  (XLA on the
    CPU also flushes subnormals to zero; the port keeps them, as CUDA
    does.)"""
    n = values.shape[0]
    if n == 1:
        return values
    bits = values.view(torch.int32)
    nan = torch.isnan(values)
    negative = bits < 0
    first_wins = nan & (~negative if op == "min" else negative)
    last_wins = nan & (negative if op == "min" else ~negative)
    idx = torch.arange(n, dtype=torch.int64, device=values.device)
    # in [2^31, 2^32) the first NaN of its kind outranks later ones, in
    # [1, 2^31) the last outranks earlier ones; 0 is no NaN
    rank = torch.where(first_wins, _MASK32 - idx, torch.where(last_wins, idx + 1, 0))
    pick = _cummax((seg << 32) | rank) & _MASK32
    at = torch.where(pick > _MASK32 >> 1, _MASK32 - pick, pick - 1).clamp_(min=0)
    nan_bits = bits[at] | _QUIET_BIT
    out = scanned.view(torch.int32)
    out = torch.where(out == torch.iinfo(torch.int32).min, 0, out)  # -0.0 -> +0.0
    return torch.where(pick > 0, nan_bits, out).view(torch.float32)


def _segmented_scan(values: torch.Tensor, is_start: torch.Tensor, op: str) -> torch.Tensor:
    """Inclusive segmented min or max of ``values`` over the runs that
    ``is_start`` opens: the running max of (run index << 32 | order key), the run
    index rising at each start, so no run sees an earlier one.  float32
    values order in IEEE-754 totalOrder, and then NaNs and zeros take the
    JAX package's bytes (:func:`_float_nan_and_zero`)."""
    if values.shape[0] >= 1 << 31:  # run indices and NaN ranks take 31 bits
        raise ValueError("group min and max take fewer than 2^31 rows")
    key = _order_key(values)
    if op == "min":
        key = _MASK32 - key
    seg = torch.cumsum(is_start, 0, dtype=torch.int64) - 1
    scanned = _cummax((seg << 32) | key) & _MASK32
    if op == "min":
        scanned = _MASK32 - scanned
    out = _from_order_key(scanned, values.dtype)
    if values.dtype == torch.float32:
        return _float_nan_and_zero(values, seg, out, op)
    return out


def group_aggregate_sorted(
    sorted_keys, values=None, op: str = "sum",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group-by over uint32 keys whose equal keys are adjacent (sorted, or
    any clustering such as hash order): one output row per run.

    Returns ``(unique_keys, aggregates, ngroups)``, the first two of length
    n (rows past ``ngroups`` are padding, unspecified), ``ngroups`` an int32
    scalar tensor.  ``values=None`` with op "sum" or "count" aggregates
    ones (float32 for "sum", uint32 for "count")."""
    if op not in VALID_AGG_OPS:
        raise ValueError(f"op must be one of {VALID_AGG_OPS}, got {op!r}")
    if values is None and op in ("min", "max"):
        raise ValueError(f"op={op!r} requires explicit values")
    k = _u32(as_tensor(sorted_keys))
    n = k.shape[0]
    if values is None or op == "count":
        if op == "count":
            values = torch.ones(n, dtype=torch.int32, device=k.device).view(KEY_DTYPE)
            op = "sum"
        else:
            values = torch.ones(n, dtype=torch.float32, device=k.device)
    values = as_tensor(values)
    if values.dtype == torch.bool:
        raise TypeError("aggregate integer or float values, not bool")
    if values.shape[0] != n:
        raise ValueError(f"values leading axis {values.shape[0]} != len(keys) {n}")
    if n == 0:
        return k, values, torch.zeros((), dtype=torch.int32, device=k.device)

    boundary = k.view(torch.int32)[1:] != k.view(torch.int32)[:-1]
    one = torch.ones(1, dtype=torch.bool, device=k.device)
    is_start = torch.cat([one, boundary])
    is_end = torch.cat([boundary, one])

    if op == "sum" and values.is_floating_point():
        uniq, count = compact(k, is_start)
        return uniq, _segment_sum(values, is_start), count
    if op == "sum":
        csum = torch.cumsum(_as_int64(values), 0)  # the differences are exact mod 2^bits
        uniq, ecsum, count = pack_by_mask(is_end, k, csum)
        prev = torch.cat([ecsum.new_zeros(1), ecsum[:-1]])
        return uniq, _wrap(ecsum - prev, values.dtype), count
    uniq, agg, count = pack_by_mask(is_end, k, _segmented_scan(values, is_start, op))
    return uniq, agg, count


def group_aggregate(
    keys, values=None, op: str = "sum",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group-by over unsorted uint32 keys: a stable key-value sort
    (:func:`sort_key_value`; keys only, :func:`sort_full`), then
    :func:`group_aggregate_sorted`.  Also the local combiner of a
    distributed aggregate: a hot key becomes one row."""
    if op not in VALID_AGG_OPS:
        raise ValueError(f"op must be one of {VALID_AGG_OPS}, got {op!r}")
    keys = _u32(as_tensor(keys))
    if values is None:
        return group_aggregate_sorted(sort_full(keys), None, op)
    sorted_keys, sorted_values = sort_key_value(keys, values)
    return group_aggregate_sorted(sorted_keys, sorted_values, op)
