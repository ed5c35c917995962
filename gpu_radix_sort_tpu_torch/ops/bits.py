"""Digit and bit-field helpers, and the order-preserving key codecs.

Port of ``gpu_radix_sort_tpu/ops/bits.py``.  Keys are uint32 (or, for the
64-bit sorts, uint64 / int64 / float64) tensors at the API edge.  PyTorch implements few operations on
``torch.uint32`` (no ``>>``, ``searchsorted``, ``flip`` or ``max`` on the
CPU), so the helpers here compute on int32 views or on int64 copies and
return uint32 only at the end.  The signed view ``decode_ordered(x,
torch.int32)`` of uint32 keys is an order isomorphism (x ^ 0x8000_0000), so
an int32 sort of it is a uint32 sort.

64-bit words are int64 inside the port, in the sign-flipped ("sortable")
domain of :func:`encode_ordered64` -- an int64 sort of them is the key
order -- or (hi, lo) uint32 word lanes of the encoded word; they become
uint64 / int64 / float64 only at the API edge.
"""

from __future__ import annotations

import torch

KEY_DTYPE = torch.uint32
KEY_BITS = 32
_INT32_MIN = -(1 << 31)
INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1
KEY64_DTYPES = (torch.uint64, torch.int64, torch.float64)


def as_tensor(x) -> torch.Tensor:
    """The tensor an entry point works on.  A tensor stays where it lies; any
    other input (a numpy array, a list) goes to the CUDA device, as the JAX
    package puts a host array on its default device.  With no CUDA device
    that raises: pass a CPU tensor to sort on the CPU."""
    if isinstance(x, torch.Tensor):
        return x
    if not torch.cuda.is_available():
        raise RuntimeError(
            "host input goes to the CUDA device and none is available; "
            "pass a CPU torch.Tensor to sort on the CPU"
        )
    return torch.as_tensor(x, device="cuda")


RAW_DTYPES = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def raw_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` viewed as the signed integer type of its element size (uint8
    for one byte): indexing ops that PyTorch lacks for uint16/32/64 on some
    devices move the same bytes through it."""
    return x.view(RAW_DTYPES[x.element_size()])


def validate_digit_range(offset: int, width: int) -> None:
    if not (0 < width <= KEY_BITS and 0 <= offset and offset + width <= KEY_BITS):
        raise ValueError(
            f"digit range [offset={offset}, offset+width={offset + width}) "
            f"must lie within [0, {KEY_BITS}) with width >= 1"
        )


def digit_mask(width: int) -> int:
    return 0xFFFFFFFF if width == KEY_BITS else (1 << width) - 1


def to_int64(x: torch.Tensor) -> torch.Tensor:
    """uint32 keys as int64 values in [0, 2^32)."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def from_int64(y: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as uint32 keys."""
    y = torch.where(y >= 1 << 31, y - (1 << 32), y)
    return y.to(torch.int32).view(torch.uint32)


def extract_digits(keys: torch.Tensor, offset: int, width: int) -> torch.Tensor:
    """bits [offset, offset+width) of each key, as uint32."""
    validate_digit_range(offset, width)
    return from_int64((to_int64(as_tensor(keys)) >> offset) & digit_mask(width))


def sortable_digits(
    keys: torch.Tensor, offset: int, width: int, *, top: int | None = None
) -> torch.Tensor:
    """Digits of uint32 keys in the narrowest type that every device sorts
    and searches in the same order: uint8, int16 or int32 by the largest
    value ``top`` it must hold (default the largest digit); width 32 is the
    sign-flipped int32 view of the keys."""
    validate_digit_range(offset, width)
    x = keys.view(torch.int32)
    if width == KEY_BITS:
        return x ^ _INT32_MIN
    # arithmetic shift: the sign bits it brings in lie above the mask
    d = (x >> offset) & digit_mask(width)
    top = digit_mask(width) if top is None else top
    if top <= 0xFF:
        return d.to(torch.uint8)
    return d.to(torch.int16) if top <= 0x7FFF else d


def rotr32(x: torch.Tensor, s: int) -> torch.Tensor:
    """Static cyclic right-rotation of uint32 bit patterns (s mod 32), on
    the int32 view: the arithmetic shift's sign bits lie above the mask,
    and the left shift wraps modulo 2^32."""
    s %= 32
    if s == 0:
        return x
    y = x.view(torch.int32)
    return ((y >> s) & ((1 << (32 - s)) - 1) | (y << (32 - s))).view(torch.uint32)


def encode_ordered(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection from int32 / float32 / uint32 keys onto
    uint32: identity for uint32, sign-bit flip for int32, IEEE-754
    totalOrder for float32 (negatives fully complemented, -0.0 < +0.0,
    positive NaNs above +inf, negative NaNs below -inf)."""
    if x.dtype == torch.uint32:
        return x
    if x.dtype == torch.int32:
        return (x ^ _INT32_MIN).view(torch.uint32)
    if x.dtype == torch.float32:
        i = x.view(torch.int32)
        # all ones for negatives, the sign bit alone otherwise
        return (i ^ ((i >> 31) | _INT32_MIN)).view(torch.uint32)
    raise TypeError(f"unsupported key dtype {x.dtype}; use uint32/int32/float32")


def decode_ordered(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`encode_ordered` for the given original dtype."""
    if dtype == torch.uint32:
        return u
    a = u.view(torch.int32)
    if dtype == torch.int32:
        return a ^ _INT32_MIN
    if dtype == torch.float32:
        # top bit set: was a non-negative float, flip the sign bit only
        return (a ^ (~(a >> 31) | _INT32_MIN)).view(torch.float32)
    raise TypeError(f"unsupported key dtype {dtype}; use uint32/int32/float32")


# ---------------------------------------------------------------------------
# 64-bit words
# ---------------------------------------------------------------------------

def rotr64_lanes(
    hi: torch.Tensor, lo: torch.Tensor, s: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Static cyclic right-rotation of 64-bit values held as (hi, lo) uint32
    word lanes: (hi', lo') of rotr64((hi << 32) | lo, s)."""
    s %= 64
    if s == 0:
        return hi, lo
    if s == 32:
        return lo, hi
    if s > 32:
        hi, lo = lo, hi
        s -= 32
    a, b = to_int64(hi), to_int64(lo)
    new_lo = from_int64(((b >> s) | (a << (32 - s))) & 0xFFFFFFFF)
    new_hi = from_int64(((a >> s) | (b << (32 - s))) & 0xFFFFFFFF)
    return new_hi, new_lo


def rotr64(w: torch.Tensor, s: int) -> torch.Tensor:
    """Static cyclic right-rotation of the 64-bit patterns of int64 ``w``."""
    s %= 64
    if s == 0:
        return w
    # arithmetic shift: the sign bits it brings in lie above the mask
    return ((w >> s) & ((1 << (64 - s)) - 1)) | (w << (64 - s))


def encode_ordered64(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection from uint64 / int64 / float64 keys onto
    int64 (the sign-flipped domain: an int64 sort of the result is the keys'
    order): sign-bit flip for uint64, identity for int64, IEEE-754
    totalOrder for float64 (-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf <
    +NaN).  As bits, ``result ^ (1 << 63)`` is the JAX package's
    :func:`encode_ordered_np64` word."""
    if x.dtype == torch.uint64:
        return x.view(torch.int64) ^ INT64_MIN
    if x.dtype == torch.int64:
        return x
    if x.dtype == torch.float64:
        i = x.view(torch.int64)
        # negatives: every bit but the sign flipped, so their order reverses
        return i ^ ((i >> 63) & _INT64_MAX)
    raise TypeError(f"unsupported key dtype {x.dtype}; use uint64/int64/float64")


def decode_ordered64(s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`encode_ordered64` for the given original dtype."""
    if dtype == torch.uint64:
        return (s ^ INT64_MIN).view(torch.uint64)
    if dtype == torch.int64:
        return s
    if dtype == torch.float64:
        return (s ^ ((s >> 63) & _INT64_MAX)).view(torch.float64)
    raise TypeError(f"unsupported key dtype {dtype}; use uint64/int64/float64")


def split_words(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) uint32 word lanes of the encoded words of sortable int64
    ``s`` (see :func:`encode_ordered64`); little-endian, as CPUs and CUDA
    devices are."""
    w = s.contiguous().view(torch.int32).view(-1, 2)
    return (w[:, 1] ^ _INT32_MIN).view(torch.uint32), w[:, 0].contiguous().view(torch.uint32)


def join_words(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_words`: sortable int64 from (hi, lo)."""
    w = torch.stack([lo.view(torch.int32), hi.view(torch.int32) ^ _INT32_MIN], dim=1)
    return w.view(torch.int64).view(-1)


def digits64(s: torch.Tensor, offset: int, width: int) -> torch.Tensor:
    """Bits [offset, offset+width) of the encoded words of sortable int64
    ``s``, as uint32 (width <= 32)."""
    # arithmetic shift: the sign bits it brings in lie above the mask
    return from_int64(((s ^ INT64_MIN) >> offset) & digit_mask(width))


# numpy forms, for the host (oracles, and callers that hold numpy keys)

def _ordered_codec_np(a, dtype, decode: bool):
    import numpy as np

    dtype = np.dtype(dtype)
    sign = np.uint64(1 << 63)
    ones = np.uint64((1 << 64) - 1)
    if dtype == np.uint64:
        return a
    if dtype == np.int64:
        return (a ^ sign).view(np.int64) if decode else a.view(np.uint64) ^ sign
    if dtype == np.float64:
        if decode:
            return (a ^ np.where((a >> np.uint64(63)) != 0, sign, ones)).view(np.float64)
        u = a.view(np.uint64)
        return u ^ np.where((u >> np.uint64(63)) != 0, ones, sign)
    raise TypeError(f"unsupported key dtype {dtype}; use uint64/int64/float64")


def encode_ordered_np64(x):
    """numpy: order-preserving bijection from uint64 / int64 / float64 keys
    onto uint64 (float64 in IEEE-754 totalOrder)."""
    return _ordered_codec_np(x, x.dtype, decode=False)


def decode_ordered_np64(u, dtype):
    """numpy inverse of :func:`encode_ordered_np64`."""
    return _ordered_codec_np(u, dtype, decode=True)
