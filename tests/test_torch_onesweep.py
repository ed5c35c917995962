"""The PyTorch port's onesweep radix sort (ops/onesweep.py) on the CPU: the
kernels' arithmetic as sort_emulated repeats it (each tile's warp-striped
count, scan and place, the decoupled look-back in orders drawn from a seed
on one state carried over four passes, the exact counts recovered from
counts mod 2^value_bits, the stores), the plain version against np.sort and
the JAX package's sort_full, and sort_full's route.  csrc/onesweep.cu itself
is held against torch.sort on the card by ``chip_smoke.py --onesweep``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu.ops import radix_sort as jax_radix_sort
from gpu_radix_sort_tpu_torch.ops import block_sort as bs
from gpu_radix_sort_tpu_torch.ops import onesweep as osw
from gpu_radix_sort_tpu_torch.ops import radix_sort


def _keys(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """uniform; all equal; 0 and 0xFFFFFFFF; uniform with 20% slack keys of
    0xFFFFFFFF; three values of every byte."""
    rng = np.random.default_rng(seed + n)
    a = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    if kind == "equal":
        return np.full(n, 0x1E3779B9, np.uint32)
    if kind == "zero-max":
        return np.where(a & 1, np.uint32(0xFFFFFFFF), np.uint32(0))
    if kind == "slack20":
        return np.where(rng.random(n) < 0.2, np.uint32(0xFFFFFFFF), a)
    if kind == "few":
        return (a % 3) * np.uint32(0x01010101)
    return a


KINDS = ["random", "equal", "zero-max", "slack20", "few"]

# A small geometry: two warps of three keys (tiles of 192), counts mod 2^10,
# so that counts before a tile pass 2^10 and their recovery is exercised.
SMALL = dict(threads=64, keys=3, value_bits=10)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 5, 191, 192, 193, 1000, 2048])
def test_emulated_passes_small_geometry(n, kind):
    """Every slot written once, each pass stable, the exact counts recovered
    from counts mod 2^10, in look-back orders drawn from three seeds with 1,
    4 and 7 tiles in flight."""
    a = _keys(kind, n)
    for seed, resident in ((0, 1), (1, 4), (2, 7)):
        got = osw.sort_emulated(torch.from_numpy(a), seed=seed, resident=resident, **SMALL)
        np.testing.assert_array_equal(got.numpy(), np.sort(a))


@pytest.mark.parametrize("kind", ["random", "slack20", "equal"])
@pytest.mark.parametrize("n", [1 << 14, (1 << 14) + 1, osw.TILE - 1, osw.TILE,
                               osw.TILE + 1, 2 * osw.TILE + 777])
def test_emulated_passes_kernel_geometry(n, kind):
    a = _keys(kind, n)
    got = osw.sort_emulated(torch.from_numpy(a), seed=n, resident=3)
    np.testing.assert_array_equal(got.numpy(), np.sort(a))


def test_emulation_refuses_counts_it_cannot_recover():
    with pytest.raises(ValueError, match="exact ones up to"):
        osw.sort_emulated(torch.zeros(2049, dtype=torch.uint32), **SMALL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [0, 1 << 14, (1 << 14) + 1, osw.TILE + 5, 3 * osw.TILE + 1])
def test_plain_matches_numpy_and_jax(n, kind):
    a = _keys(kind, n)
    got = osw.sort_full_onesweep(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, np.sort(a))
    if n:
        np.testing.assert_array_equal(got, np.asarray(jax_radix_sort.sort_full(jnp.asarray(a))))


def test_route_by_size():
    assert radix_sort._resolve("auto", bs.TILE + 1) == "merge"
    assert radix_sort._resolve("auto", radix_sort.ONESWEEP_MIN_N - 1) == "merge"
    assert radix_sort._resolve("auto", radix_sort.ONESWEEP_MIN_N) == "onesweep"
    assert radix_sort._resolve(None, 1 << 30) == "onesweep"
    assert radix_sort._resolve(None, osw.MAX_N) == "onesweep"
    assert radix_sort._resolve(None, osw.MAX_N + 1) == "merge"
    assert radix_sort._resolve("torch", radix_sort.ONESWEEP_MIN_N) == "torch"
    assert radix_sort.ONESWEEP_MIN_N > bs.TILE + 1


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_sort_full_takes_the_onesweep_route(dtype):
    n = radix_sort.ONESWEEP_MIN_N + 3
    a = _keys("slack20", n).view(dtype)
    got = radix_sort.sort_full(torch.from_numpy(a)).numpy()
    want = np.asarray(jax_radix_sort.sort_full(jnp.asarray(a)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_wrapper_checks(monkeypatch):
    with pytest.raises(TypeError, match="uint32"):
        osw.sort_full_onesweep(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(TypeError, match="contiguous"):
        osw.sort_full_onesweep(torch.zeros(16, dtype=torch.uint32)[::2])
    monkeypatch.setattr(osw, "MAX_N", 10)
    with pytest.raises(ValueError, match="at most 10 keys"):
        osw.sort_full_onesweep(torch.zeros(11, dtype=torch.uint32))


def test_scratch_and_status_codes():
    """The scratch beyond the two key buffers stays under 16 MiB at 2^28
    keys; the status codes of each pass tell PREFIX, AGGREGATE and "not
    ready" apart, and a pass's "not ready" is the last pass's PREFIX."""
    assert osw.scratch_words(1 << 28) * 4 <= 16 << 20
    assert osw.scratch_words(osw.TILE) == osw.HEADER_WORDS
    assert osw.scratch_words(osw.TILE + 1) == osw.HEADER_WORDS + osw.BINS
    for p in range(osw.PASSES):
        codes = {osw.prefix_code(p), osw.wait_code(p), osw.AGGREGATE}
        assert len(codes) == 3 and codes <= {0, 1, 2, 3}
        assert osw.wait_code(p) == (0 if p == 0 else osw.prefix_code(p - 1))
