"""Digit and bit-field helpers, and the order-preserving key codecs.

Port of ``gpu_radix_sort_tpu/ops/bits.py`` (32-bit part).  Keys are uint32
tensors at the API edge.  PyTorch implements few operations on
``torch.uint32`` (no ``>>``, ``searchsorted``, ``flip`` or ``max`` on the
CPU), so the helpers here compute on int32 views or on int64 copies and
return uint32 only at the end.  The signed view ``decode_ordered(x,
torch.int32)`` of uint32 keys is an order isomorphism (x ^ 0x8000_0000), so
an int32 sort of it is a uint32 sort.
"""

from __future__ import annotations

import torch

KEY_DTYPE = torch.uint32
KEY_BITS = 32
_INT32_MIN = -(1 << 31)


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
    """Static cyclic right-rotation of uint32 bit patterns (s mod 32)."""
    s %= 32
    if s == 0:
        return x
    y = to_int64(x)
    return from_int64(((y >> s) | (y << (32 - s))) & 0xFFFFFFFF)


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
