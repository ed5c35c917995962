"""Single-device sort core: full, partial and digit sorts over uint32 keys.

Port of ``gpu_radix_sort_tpu/ops/radix_sort.py``:

  * :func:`sort_full` — ascending full sort (reference: invokers.cu:45),
    int32 / float32 keys through the order-preserving codec.
  * :func:`sort_by_digits` / :func:`sort_partial` /
    :func:`sort_partial_counts` — the stable digit sort (reference:
    invokers.cu:15) with the reference's boundaries or exact counts;
    ``stable=False`` is the reference's checked contract through a rotation
    around :func:`sort_full` (sort.cu:367-394).
  * :func:`sort_key_value` / :func:`sort_key_value_by_digits` — stable
    full and digit sorts of (key, value) rows, values of any shape whose
    leading axis is n (the reference's paired key/value pipeline,
    libsort/sort.cu:29-213).
  * :func:`sort_full_u64`, :func:`sort_key_value_u64`,
    :func:`sort_partial_u64`, :func:`sort_partial_counts_u64` — the same
    over uint64 / int64 / float64 keys (float64 in IEEE-754 totalOrder).

Strategies (per call, or via :func:`set_default_strategy`):
  * ``"auto"``  — the hand-written kernels.  Full sorts: n <= TILE keys in
    one block (``single_block``), larger n through ``sort_full_large``.  Digit
    sorts: n <= MAX_N_KV with width + pos_bits < 32 in one block
    (``digit_sort``), anything else through binning passes.  Key-value sorts
    at every n through binning passes, which carry one 4-byte value column,
    or else a row-index column by which one gather moves the payload rows.
    On a CPU tensor the same routes run the kernels' plain versions.
  * ``"torch"`` — ``torch.sort``, an explicit choice only.

The 64-bit sorts take no strategy: their stable paths run binning passes
(the digit, or each 32-bit word in turn, carrying the other words as
columns), their keys-only paths one ``torch.sort`` of the sign-flipped
int64 words (the JAX package's ``lax.sort``, outside its kernels).

Every entry point sorts a tensor where it lies and sends any other input
(a numpy array) to the CUDA device (:func:`ops.bits.as_tensor`).
"""

from __future__ import annotations

import torch

from . import binning, block_sort, digit_sort, merge_sort, single_block
from .bits import (
    INT64_MIN, KEY64_DTYPES, KEY_DTYPE, as_tensor, decode_ordered,
    decode_ordered64, digit_mask, digits64, encode_ordered, encode_ordered64,
    from_int64, join_words, raw_view, rotr32, rotr64, sortable_digits, split_words,
    validate_digit_range,
)
from .boundaries import compute_boundaries, digit_counts_sorted

_DEFAULT_STRATEGY = "auto"
_VALID = ("auto", "torch")


def set_default_strategy(name: str) -> None:
    global _DEFAULT_STRATEGY
    if name not in _VALID:
        raise ValueError(f"strategy must be one of {_VALID}, got {name!r}")
    _DEFAULT_STRATEGY = name


def get_default_strategy() -> str:
    return _DEFAULT_STRATEGY


def _resolve(
    strategy: str | None, n: int, kind: str = "full", width: int | None = None
) -> str:
    """The route a sort of n keys takes: "single_block" or "merge" for a full
    sort, "digit_sort" or "binning" for a stable digit sort (kind "kv") by
    ``width`` bits, or "torch"."""
    name = strategy or _DEFAULT_STRATEGY
    if name not in _VALID:
        raise ValueError(f"strategy must be one of {_VALID}, got {name!r}")
    if name == "torch":
        return "torch"
    if kind == "kv":
        return "digit_sort" if digit_sort.supported(n, width) else "binning"
    return "single_block" if n <= single_block.MAX_N else "merge"


def _sort_full_torch(keys: torch.Tensor) -> torch.Tensor:
    return encode_ordered(torch.sort(decode_ordered(keys, torch.int32)).values)


def sort_full(keys, *, strategy: str | None = None) -> torch.Tensor:
    """Ascending full sort of uint32 keys (int32 / float32 accepted through
    :func:`ops.bits.encode_ordered`; float32 in IEEE-754 totalOrder)."""
    keys = as_tensor(keys)
    if keys.dtype in (torch.int32, torch.float32):
        return decode_ordered(
            sort_full(encode_ordered(keys), strategy=strategy), keys.dtype
        )
    if keys.dtype != KEY_DTYPE:
        raise TypeError(f"unsupported key dtype {keys.dtype}; use uint32/int32/float32")
    keys = keys.contiguous()
    route = _resolve(strategy, keys.numel())
    if route == "torch":
        return _sort_full_torch(keys)
    if route == "single_block":
        return single_block.sort_single_block(keys)
    return merge_sort.sort_full_large(keys)


def _sort_by_digits_rotated(
    keys: torch.Tensor, offset: int, width: int, strategy: str | None
) -> torch.Tensor:
    """Rotate the word so the digit occupies the top bits, run a keys-only
    full sort, rotate back: digit groups in order, the multiset kept, and
    within a group the rotated-value order (a pure function of the
    values)."""
    s = (offset + width) % 32
    z = sort_full(rotr32(keys, s), strategy=strategy)
    return rotr32(z, (32 - s) % 32)


def _digit_order(keys: torch.Tensor, offset: int, width: int) -> torch.Tensor:
    """The stable digit-sort permutation by ``torch.sort`` of the narrow
    digits (``strategy="torch"``)."""
    return torch.sort(sortable_digits(keys, offset, width), stable=True).indices


def _sort_partial_torch(keys: torch.Tensor, offset: int, width: int) -> torch.Tensor:
    return keys.view(torch.int32)[_digit_order(keys, offset, width)].view(KEY_DTYPE)


def _digit_keys(keys, offset: int, width: int) -> torch.Tensor:
    validate_digit_range(offset, width)
    keys = as_tensor(keys)
    if keys.dtype != KEY_DTYPE or keys.dim() != 1:
        raise TypeError(
            f"digit sorts take 1-D uint32 keys, got {keys.dtype} "
            f"shape {tuple(keys.shape)}"
        )
    return keys.contiguous()


def sort_by_digits(
    keys, offset: int, width: int, *, strategy: str | None = None,
    stable: bool = True,
) -> torch.Tensor:
    """Sort by bits [offset, offset+width).

    ``stable=True`` (default): stable by input order within equal digits,
    the contract LSD rounds compose on.  ``stable=False``: the reference's
    checked contract only (digit groups in order, the multiset kept; within
    a group the rotated-value order) through a keys-only full sort."""
    keys = _digit_keys(keys, offset, width)
    if not stable:
        return _sort_by_digits_rotated(keys, offset, width, strategy)
    route = _resolve(strategy, keys.numel(), "kv", width)
    if route == "torch":
        return _sort_partial_torch(keys, offset, width)
    if route == "digit_sort":
        return digit_sort.sort_by_digits_small(keys, offset, width)
    return binning.sort_by_digits_large(keys, offset, width)


def sort_partial(
    keys, offset: int, width: int, *, strategy: str | None = None,
    stable: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Partial sort + reference-contract boundaries: returns
    ``(sorted_keys, boundaries)``, boundaries uint32[2^width]
    (invokers.cu:15 + sort.cu:367-394).  Boundaries do not depend on the
    order within a group, so ``stable`` does not change them."""
    sorted_keys = sort_by_digits(
        keys, offset, width, strategy=strategy, stable=stable
    )
    return sorted_keys, compute_boundaries(sorted_keys, offset, width)


def sort_partial_counts(
    keys, offset: int, width: int, *, strategy: str | None = None,
    stable: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Partial sort + exact per-digit counts (int32[2^width]), free of the
    reference boundary contract's quirks for empty groups 0 and 1."""
    sorted_keys = sort_by_digits(
        keys, offset, width, strategy=strategy, stable=stable
    )
    return sorted_keys, digit_counts_sorted(sorted_keys, offset, width)


_COLUMN_DTYPES = (KEY_DTYPE, torch.int32, torch.float32)


def _kv_values(keys: torch.Tensor, values) -> torch.Tensor:
    """The payload of a key-value sort: any shape whose leading axis is n,
    on the keys' device."""
    values = as_tensor(values)
    if values.dim() == 0 or values.shape[0] != keys.shape[0]:
        raise ValueError(
            f"values leading axis {values.shape[0] if values.dim() else None} "
            f"!= len(keys) {keys.shape[0]}"
        )
    if values.device != keys.device:
        raise ValueError(f"keys on {keys.device} but values on {values.device}")
    return values


def _is_column(values: torch.Tensor) -> bool:
    """Whether the payload rides the binning passes itself: one column of a
    4-byte type.  Any other payload rides as a row-index column."""
    return values.dim() == 1 and values.dtype in _COLUMN_DTYPES


def _as_column(values: torch.Tensor) -> torch.Tensor:
    return values.contiguous().view(torch.int32).view(KEY_DTYPE)


# words a payload row moves as: the widest that divides the row's bytes
_WORDS = ((16, torch.complex128), (8, torch.int64), (4, torch.int32), (2, torch.int16),
          (1, torch.uint8))
GATHER_CHUNK = 1 << 24  # index elements of one materialized gather (128 MiB)


def _gather_rows(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Rows ``order`` (int32 or int64) of ``values``, each row moved as the
    widest words that divide its bytes.  PyTorch's row gathers (index_select,
    and gather by an index expanded along the row) launch a block a row once
    a row holds 16 bytes or more: 2^27 rows then take ~81 ms on an H100
    whatever their width, against ~5 ms for one element a row
    (tools/gather_variants.py).  So rows under 16 bytes go through
    ``index_select``, a row of one 16-byte word through ``gather``, and
    wider rows through ``gather`` by an index materialized per word, in
    chunks of GATHER_CHUNK.  (The JAX package moves wide payloads by
    lane-riding sorts keyed by each row's rank, as XLA's gather was slow on
    the TPU, radix_sort.py:34-37, 68-96.)"""
    if values.numel() == 0:
        return values.new_empty((order.numel(), *values.shape[1:]))
    n = values.shape[0]
    # flat first: a contiguous tensor may carry any stride on a dimension of
    # size 1 (torch.from_numpy(a[:, None]) has 0), which a view to bytes refuses
    rows = raw_view(values.contiguous()).reshape(-1).view(torch.uint8).reshape(n, -1)
    nbytes = rows.shape[1]
    dtype = next(d for w, d in _WORDS if nbytes % w == 0)
    words = rows.view(dtype)
    if nbytes < 16:
        out = words.index_select(0, order)
    elif words.shape[1] == 1:
        out = torch.gather(words, 0, order.to(torch.int64)[:, None])
    else:
        out = torch.empty((order.numel(), words.shape[1]), dtype=dtype, device=words.device)
        order = order.to(torch.int64)
        step = max(1, GATHER_CHUNK // words.shape[1])
        for c in range(0, order.numel(), step):
            index = order[c:c + step, None].expand(-1, words.shape[1]).contiguous()
            torch.gather(words, 0, index, out=out[c:c + step])
    return out.view(torch.uint8).view(values.dtype).reshape(order.numel(), *values.shape[1:])


def _row_index(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device).view(KEY_DTYPE)


def _sort_key_value_digits(
    keys: torch.Tensor, values: torch.Tensor, offset: int, width: int,
    strategy: str | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of (key, value) rows by bits [offset, offset+width) of
    the uint32 keys: binning passes carrying the one value column or a
    row index, or (``"torch"``) a stable ``torch.sort`` of the digits; a
    row index ends in one gather of the payload rows."""
    if _resolve(strategy, keys.numel(), "kv", width) == "torch":
        order = _digit_order(keys, offset, width)
        return keys.view(torch.int32)[order].view(KEY_DTYPE), _gather_rows(values, order)
    if _is_column(values):
        sk, (sv,) = binning.sort_key_value_by_digits_large(
            keys, (_as_column(values),), offset, width
        )
        return sk, sv.view(torch.int32).view(values.dtype)
    sk, (order,) = binning.sort_key_value_by_digits_large(
        keys, (_row_index(keys.numel(), keys.device),), offset, width
    )
    return sk, _gather_rows(values, order.view(torch.int32))


def sort_key_value(
    keys, values, *, strategy: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending full sort of (key, value) rows: equal keys keep
    their input order, so payload placement is deterministic.  Keys are
    uint32, int32 or float32 (through :func:`ops.bits.encode_ordered`);
    ``values`` may be any dtype and shape whose leading axis is len(keys).
    ``"auto"``: a 32-bit LSD sort as binning passes; ``"torch"``: a stable
    ``torch.sort`` of the sign-flipped keys and a gather."""
    keys = as_tensor(keys)
    if keys.dtype in (torch.int32, torch.float32):
        sk, sv = sort_key_value(encode_ordered(keys), values, strategy=strategy)
        return decode_ordered(sk, keys.dtype), sv
    if keys.dtype != KEY_DTYPE or keys.dim() != 1:
        raise TypeError(
            f"sort_key_value takes 1-D uint32/int32/float32 keys, got "
            f"{keys.dtype} shape {tuple(keys.shape)}"
        )
    keys = keys.contiguous()
    return _sort_key_value_digits(keys, _kv_values(keys, values), 0, 32, strategy)


def sort_key_value_by_digits(
    keys, values, offset: int, width: int, *, strategy: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable digit sort of (key, value) rows by bits [offset, offset+width)
    of uint32 keys; ``values`` may be any dtype and shape whose leading axis
    is len(keys).  ``"auto"`` runs binning passes that carry one 4-byte
    value column, or a row index for any other payload and then one gather
    of its rows; ``"torch"`` a stable ``torch.sort`` of the digits and a
    gather."""
    keys = _digit_keys(keys, offset, width)
    return _sort_key_value_digits(
        keys, _kv_values(keys, values), offset, width, strategy
    )


# ---------------------------------------------------------------------------
# 64-bit keys
# ---------------------------------------------------------------------------

def _keys64(keys, what: str) -> torch.Tensor:
    keys = as_tensor(keys)
    if keys.dtype not in KEY64_DTYPES or keys.dim() != 1:
        raise TypeError(
            f"{what} takes 1-D uint64/int64/float64 keys, got {keys.dtype} "
            f"shape {tuple(keys.shape)}"
        )
    return keys.contiguous()


def sort_full_u64(keys) -> torch.Tensor:
    """Ascending full sort of 64-bit keys (uint64 / int64 / float64, float64
    in IEEE-754 totalOrder), returned in the keys' dtype: one ``torch.sort``
    of the sign-flipped int64 words."""
    keys = _keys64(keys, "sort_full_u64")
    return decode_ordered64(torch.sort(encode_ordered64(keys)).values, keys.dtype)


def sort_key_value_u64(keys, values) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending full sort of (key, value) rows keyed by 64-bit keys
    (uint64 / int64 / float64 totalOrder); ``values`` may be any dtype and
    shape whose leading axis is len(keys).  LSD over the encoded words'
    32-bit halves as binning passes, low word first, each word carrying the
    other and the payload's column (one 4-byte value column, or a row index
    and then one gather of the payload rows)."""
    keys = _keys64(keys, "sort_key_value_u64")
    values = _kv_values(keys, values)
    hi, lo = split_words(encode_ordered64(keys))
    column = _is_column(values)
    payload = _as_column(values) if column else _row_index(keys.numel(), keys.device)
    lo, (hi, payload) = binning.sort_key_value_by_digits_large(lo, (hi, payload), 0, 32)
    hi, (lo, payload) = binning.sort_key_value_by_digits_large(hi, (lo, payload), 0, 32)
    out_keys = decode_ordered64(join_words(hi, lo), keys.dtype)
    if column:
        return out_keys, payload.view(torch.int32).view(values.dtype)
    return out_keys, _gather_rows(values, payload.view(torch.int32))


def _validate_digit_range_64(offset: int, width: int) -> None:
    if not (0 < width <= 32 and 0 <= offset and offset + width <= 64):
        raise ValueError(
            f"64-bit digit range [offset={offset}, offset+width="
            f"{offset + width}) must lie within [0, 64] with 1 <= width <= 32"
        )


def _sort_partial_u64_impl(keys, offset: int, width: int, stable: bool):
    """The digit sort of the 64-bit partial sorts: (sorted keys in their
    dtype, the sorted digits as uint32).  ``stable``: binning passes by the
    digit carrying the (hi, lo) words.  Else a ``torch.sort`` of the encoded
    words rotated so that the digit lies on top, rotated back: digit groups
    in order, within a group the rotated-value order (a pure function of the
    values)."""
    _validate_digit_range_64(offset, width)
    keys = _keys64(keys, "64-bit partial sorts")
    s = encode_ordered64(keys)
    if stable:
        hi, lo = split_words(s)
        sd, (hi, lo) = binning.sort_key_value_by_digits_large(
            digits64(s, offset, width), (hi, lo), 0, width
        )
        return decode_ordered64(join_words(hi, lo), keys.dtype), sd
    r = (offset + width) % 64
    # encoded word = s ^ MIN; sortable form of the rotated word: that ^ MIN
    rot = torch.sort(rotr64(s ^ INT64_MIN, r) ^ INT64_MIN).values ^ INT64_MIN
    sd = from_int64((rot >> (64 - width)) & digit_mask(width))
    out = rotr64(rot, (64 - r) % 64) ^ INT64_MIN
    return decode_ordered64(out, keys.dtype), sd


def sort_partial_u64(
    keys, offset: int, width: int, *, stable: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Partial sort + reference-contract boundaries (uint32[2^width]) for
    64-bit keys: digits are bits [offset, offset+width) of the
    order-preserving encoded word (offset + width <= 64, width <= 32), so
    digit groups ascend in key order.  ``stable`` as in
    :func:`sort_partial`."""
    out, sd = _sort_partial_u64_impl(keys, offset, width, stable)
    return out, compute_boundaries(sd, 0, width)


def sort_partial_counts_u64(
    keys, offset: int, width: int, *, stable: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Partial sort + exact per-digit counts (int32[2^width]) for 64-bit
    keys."""
    out, sd = _sort_partial_u64_impl(keys, offset, width, stable)
    return out, digit_counts_sorted(sd, 0, width)
