"""The merge level (B2, ops/merge_sort.py): the arithmetic of
csrc/merge_path.cu emulated in numpy block by block
(``merge_level_emulated``: each output block's two splits by 32 probes a
step, the A slice and the stored B slice staged at their word offsets mod 4
with 16-byte vectors only on 16-byte boundaries, each thread's merge path
and serial merge, the padded staging, the output reversed for an odd pair)
and held against numpy, the port's plain version and the JAX package's
``pallas_merge.merge_level`` in interpret mode.  The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py.  Keys are
integers: outputs must be equal bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu.ops import pallas_merge as pm
from gpu_radix_sort_tpu.utils.keygen import Pcg32
from gpu_radix_sort_tpu_torch.ops import merge_sort as ms

TILE, B_OUT = 2048, 512  # the JAX tests' small geometry


def alternating_runs(keys: np.ndarray, L: int) -> np.ndarray:
    """Sorted runs of length L (the last may be short), odd runs reversed:
    the merge level's input convention."""
    runs = [np.sort(keys[s:s + L]) for s in range(0, keys.size, L)]
    return np.concatenate([r[::-1] if i % 2 else r for i, r in enumerate(runs)] or [keys])


def keys_of(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return Pcg32(state=seed).fill(n)
    if kind == "ties":  # few values, both ends of the range among them
        return np.array([0, 9, 9, 0xFFFFFFFF], np.uint32)[rng.integers(0, 4, n)]
    return np.full(n, 0x9E3779B9 if kind == "all-equal" else 0xFFFFFFFF, np.uint32)


# n ragged at every L: a short last pair, or a lone last run, and pair
# boundaries (multiples of 2L) that are not multiples of 4 keys for odd L.
LEVELS = [(1, 1001), (3, 997), (128, 3 * 256 + 77), (1000, 5 * 1000 + 3), (2048, 5 * 2048 + 1)]


@pytest.mark.parametrize("kind", ["random", "ties", "all-equal", "all-max"])
@pytest.mark.parametrize("L,n", LEVELS)
def test_merge_level_emulated_matches_numpy(L, n, kind):
    keys = keys_of(kind, n, L + n)
    x = torch.from_numpy(alternating_runs(keys, L))
    want = alternating_runs(keys, 2 * L)
    got = ms.merge_level_emulated(x, L)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ms.merge_level_plain(x, L).numpy())


@pytest.mark.parametrize("x_word", [0, 1, 2, 3])
@pytest.mark.parametrize("out_word", [0, 1, 2, 3])
def test_merge_level_emulated_at_every_word_offset(x_word, out_word):
    """Input and output each starting 0-3 keys past a 16-byte boundary:
    the heads and tails change, the result does not."""
    L, n = 1000, 4 * 1000 + 333
    keys = keys_of("ties", n, x_word * 4 + out_word)
    got = ms.merge_level_emulated(torch.from_numpy(alternating_runs(keys, L)), L,
                                  x_word=x_word, out_word=out_word)
    np.testing.assert_array_equal(got.numpy(), alternating_runs(keys, 2 * L))


@pytest.mark.parametrize("threads,items", [(64, 4), (64, 5), (128, 7)])
@pytest.mark.parametrize("L", [3, 128, 1000])
def test_merge_level_emulated_small_blocks(threads, items, L):
    """Blocks much smaller than the shipped 8192 keys cut every pair of
    these sizes into many, as 8192-key blocks cut the pairs of L >= 2^13:
    splits inside both runs, slices of any length at any word offset."""
    n = 7 * L + 5
    keys = keys_of("random", n, threads + L)
    got = ms.merge_level_emulated(torch.from_numpy(alternating_runs(keys, L)), L,
                                  threads=threads, items=items, x_word=1, out_word=2)
    np.testing.assert_array_equal(got.numpy(), alternating_runs(keys, 2 * L))


@pytest.mark.parametrize("nruns", [2, 4])
def test_merge_level_emulated_matches_pallas(nruns):
    keys = Pcg32(state=nruns + 10).fill(nruns * TILE)
    n = keys.size
    x = alternating_runs(keys, TILE)
    headroom = np.zeros(pm._pad_rows(B_OUT) * 128, np.uint32)
    want = np.asarray(
        pm.merge_level(jnp.asarray(np.concatenate([x, headroom]).reshape(-1, 128)),
                       TILE, B_OUT, n=n)
    ).reshape(-1)[:n]
    got = ms.merge_level_emulated(torch.from_numpy(x), TILE)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("la,lb", [(1, 0), (5, 3), (1000, 1000), (4099, 17), (2 ** 20, 2 ** 20 - 3)])
def test_warp_split_matches_the_binary_search(la, lb, kind):
    """The 32-probe search gives the merge-path split of a plain binary
    search at every kind of diagonal: A keys among the first d of the merge,
    A first on ties (the count of A keys <= ... at the crossing)."""
    rng = np.random.default_rng(la + lb)
    a = np.sort(keys_of(kind, la, la))
    b = np.sort(keys_of(kind, lb, lb))
    x = np.concatenate([a, b[::-1]])
    diags = {0, 1, la + lb, la + lb - 1, la, lb, *rng.integers(0, la + lb + 1, 40).tolist()}
    for d in sorted(diags):
        lo, hi = max(0, d - lb), min(d, la)
        while lo < hi:  # one thread's binary search
            mid = (lo + hi) // 2
            if a[mid] <= b[d - 1 - mid]:
                lo = mid + 1
            else:
                hi = mid
        assert ms._split_warp(x, 0, la, lb, d) == lo, d
        merged = np.sort(np.concatenate([a, b]), kind="stable")
        assert np.array_equal(np.sort(np.concatenate([a[:lo], b[:d - lo]])), merged[:d])


def test_merge_level_emulated_empty_and_one_key():
    for n in (0, 1):
        x = torch.from_numpy(Pcg32(state=3).fill(n))
        np.testing.assert_array_equal(ms.merge_level_emulated(x, 4).numpy(), x.numpy())
