"""The block-local counting sort of csrc/block_rank.cuh, which B4
(digit_sort_kernel) and B7 (group_sort_send_kernel) rank with, emulated in
torch step for step (ops/digit_sort.rank_scatter_emulated: warp-striped
slots, per-(digit, warp) counters scanned digit-major, lower-lane peers)
and held against numpy's stable argsort, the port's plain versions and the
JAX package's pallas_sort.sort_by_digits in interpret mode.  The CUDA
kernels themselves are held against the plain versions on the card by
chip_smoke.py.  Keys are integers: outputs must be equal bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu.ops import pallas_sort
from gpu_radix_sort_tpu.utils.keygen import Pcg32
from gpu_radix_sort_tpu_torch.ops import digit_sort as ds
from gpu_radix_sort_tpu_torch.parallel import rdma_overlap as ov

DISTRIBUTIONS = ["uniform", "duplicate", "equal", "single-digit"]


def keys_of(dist: str, n: int, offset: int, width: int, seed: int) -> np.ndarray:
    """uniform PCG32 keys; duplicate-heavy (a quarter of the digits, other
    bits random, so a change of order within a digit shows); all keys equal
    (every lane of a warp is a peer of every other); one digit with random
    other bits."""
    keys = Pcg32(state=seed).fill(n)
    window = np.uint32(((1 << width) - 1) << offset)
    if dist == "duplicate":
        few = np.random.default_rng(seed).integers(0, max(1, (1 << width) // 4), n)
        keys = (keys & ~window) | ((few.astype(np.uint32) << np.uint32(offset)) & window)
    elif dist == "equal":
        keys = np.full(n, 0x9E3779B9, np.uint32)
    elif dist == "single-digit":
        keys = (keys & ~window) | (np.uint32(0x5A5A5A5A) & window)
    return keys


def stable_oracle(keys: np.ndarray, offset: int, width: int) -> np.ndarray:
    d = (keys >> np.uint32(offset)) & np.uint32((1 << width) - 1)
    return keys[np.argsort(d, kind="stable")]


@pytest.mark.parametrize("dist", DISTRIBUTIONS)
@pytest.mark.parametrize("width", [1, 4, 8])
@pytest.mark.parametrize("tile", [1024, 1 << 14])
def test_group_ranking_matches_numpy_stable_argsort(tile, width, dist):
    offset = {1: 31, 4: 8, 8: 13}[width]
    keys = keys_of(dist, 2 * tile, offset, width, seed=tile + width)
    x = torch.from_numpy(keys)
    got = ov.sort_groups_emulated(x, tile, offset, width).numpy().reshape(-1, tile)
    for g, row in enumerate(keys.reshape(-1, tile)):
        np.testing.assert_array_equal(got[g], stable_oracle(row, offset, width), err_msg=f"group {g}")
    np.testing.assert_array_equal(got.reshape(-1), ov.sort_groups_plain(x, tile, offset, width).numpy())


@pytest.mark.parametrize("width", [4, 8, 11, 17])
@pytest.mark.parametrize("n", [1, 31, 1000, ds.MAX_N_KV - 3, ds.MAX_N_KV])
def test_digit_sort_passes_match_numpy_stable_argsort(n, width):
    """ceil(width / 8) LSD passes over the 0xFFFFFFFF-padded block, on every
    distribution; the kernel's route limit plays no part here."""
    offset = (7 * width) % (33 - width)
    for dist in DISTRIBUTIONS:
        keys = keys_of(dist, n, offset, width, seed=n + width)
        x = torch.from_numpy(keys)
        got = ds.sort_by_digits_small_emulated(x, offset, width).numpy()
        np.testing.assert_array_equal(got, stable_oracle(keys, offset, width), err_msg=dist)
        if ds.supported(n, width):
            np.testing.assert_array_equal(got, ds.sort_by_digits_small(x, offset, width).numpy())


def test_pads_fill_the_block_and_sort_last():
    """n keys take ceil(n / 1024) slots a thread; a key of all ones ties
    with the pads in every pass and still keeps its place before them."""
    assert [ds.rank_keys_per_thread(n) for n in (1, 1024, 1025, ds.MAX_N_KV)] == [1, 1, 2, 16]
    keys = np.array([0xFFFFFFFF, 7, 0xFFFFFFFF, 0, 0xFFFFFFFF] * 201, np.uint32)
    got = ds.sort_by_digits_small_emulated(torch.from_numpy(keys), 0, 32).numpy()
    np.testing.assert_array_equal(got, np.sort(keys, kind="stable"))
    block = torch.from_numpy(np.concatenate([keys, np.full(2048 - keys.size, 0xFFFFFFFF, np.uint32)]))
    out = ds.rank_scatter_emulated(block, 0, 8).numpy()
    np.testing.assert_array_equal(out[:keys.size], stable_oracle(keys, 0, 8))


@pytest.mark.parametrize("n,offset,width", [(31, 3, 17), (3000, 7, 11)])
def test_digit_sort_passes_match_pallas(n, offset, width):
    """Two and three passes against the JAX package's composite-key network
    (interpret mode), on duplicate-heavy keys."""
    keys = keys_of("duplicate", n, offset, width, seed=n)
    want = np.asarray(pallas_sort.sort_by_digits(jnp.asarray(keys), offset, width))
    got = ds.sort_by_digits_small_emulated(torch.from_numpy(keys), offset, width)
    np.testing.assert_array_equal(got.numpy(), want)
