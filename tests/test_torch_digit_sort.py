"""PyTorch port's one-block stable digit sort (digit_sort, the port of B4)
vs the JAX package's pallas_sort.sort_by_digits in interpret mode, as
tests/test_pallas_sort.py runs it.  On a CPU tensor the port runs the
kernel's plain version; the kernel in csrc/block_sort.cu is checked against
that plain version on the card by chip_smoke.py.  Outputs must be equal
bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_radix_sort_tpu_torch as port
from gpu_radix_sort_tpu.ops import pallas_sort
from gpu_radix_sort_tpu.utils.keygen import Pcg32
from gpu_radix_sort_tpu_torch.ops import binning as bn
from gpu_radix_sort_tpu_torch.ops import digit_sort as ds
from gpu_radix_sort_tpu_torch.ops import radix_sort
from gpu_radix_sort_tpu_torch.utils import checks


def _duplicate_heavy(n: int, offset: int, width: int, seed: int) -> np.ndarray:
    """PCG32 keys with half of them given one digit: distinct keys with
    equal digits, so a change of order within a group shows."""
    keys = Pcg32(state=seed).fill(n)
    window = np.uint32(((1 << width) - 1) << offset)
    keys[::2] = (keys[::2] & ~window) | (np.uint32(3 << offset) & window)
    return keys


@pytest.mark.parametrize("n", [1, 1000, 4096])
@pytest.mark.parametrize("offset,width", [(0, 4), (8, 8), (5, 11)])
def test_digit_sort_matches_pallas(n, offset, width):
    keys = _duplicate_heavy(n, offset, width, seed=n + width)
    want = np.asarray(pallas_sort.sort_by_digits(jnp.asarray(keys), offset, width))
    got = ds.sort_by_digits_small(torch.from_numpy(keys), offset, width)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    assert checks.check_partial(got.numpy(), keys, offset, width)
    assert radix_sort._resolve(None, n, "kv", width) == "digit_sort"
    np.testing.assert_array_equal(
        port.sort_by_digits(torch.from_numpy(keys), offset, width).numpy(), want
    )


@pytest.mark.parametrize(
    "n,width,route",
    [
        (ds.MAX_N_KV, 17, "digit_sort"),  # 14 position bits + 17 = 31
        (ds.MAX_N_KV, 18, "binning"),
        (4096, 19, "digit_sort"),
        (4096, 20, "binning"),  # 12 position bits + 20 = 32
        (ds.MAX_N_KV + 1, 4, "binning"),
        (1, 31, "digit_sort"),
        (2, 31, "binning"),
    ],
)
def test_position_bits_limit_routes_to_binning(n, width, route):
    """width + pos_bits >= 32 (or n > MAX_N_KV) takes the binning passes
    rather than failing; the result is the stable oracle's either way."""
    assert ds.supported(n, width) == (route == "digit_sort")
    assert radix_sort._resolve("auto", n, "kv", width) == route
    keys = _duplicate_heavy(n, 32 - width, width, seed=width)
    before = bn.launches, ds.launches
    got = port.sort_by_digits(torch.from_numpy(keys), 32 - width, width).numpy()
    assert (bn.launches, ds.launches) == before  # CPU tensors launch nothing
    np.testing.assert_array_equal(got, checks.partial_sort_oracle(keys, 32 - width, width))
    if route == "binning":
        with pytest.raises(ValueError, match="one block sorts"):
            ds.sort_by_digits_small(torch.from_numpy(keys), 32 - width, width)


def test_equal_and_extreme_digits_keep_input_order():
    keys = np.array([0xFFFFFFFF, 0, 0x10, 0xFFFFFFF0, 0x11, 0xF0] * 300, np.uint32)
    for offset, width in [(0, 4), (4, 4), (28, 4), (0, 1)]:
        got = ds.sort_by_digits_small(torch.from_numpy(keys), offset, width).numpy()
        np.testing.assert_array_equal(got, checks.partial_sort_oracle(keys, offset, width))


def test_digit_sort_rejects_what_the_kernel_does_not_take():
    x = torch.from_numpy(Pcg32().fill(64))
    with pytest.raises(TypeError, match="uint32"):
        ds.sort_by_digits_small(x.view(torch.int32), 0, 4)
    with pytest.raises(ValueError, match="digit range"):
        ds.sort_by_digits_small(x, 30, 4)
    with pytest.raises(ValueError, match="one block sorts"):
        ds.sort_by_digits_small(x[:0], 0, 4)
    with pytest.raises(ValueError, match="one block sorts"):
        ds.sort_by_digits_small(torch.zeros(ds.MAX_N_KV + 1, dtype=torch.uint32), 0, 4)
    assert [ds.pos_bits(n) for n in (1, 2, 3, 1024, 1025)] == [0, 1, 2, 10, 11]
