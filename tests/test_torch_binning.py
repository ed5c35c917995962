"""PyTorch port's binning passes (ops/binning.py, stage B the port of B5)
vs the JAX package's ops/pallas_radix.py: stage A and the run metadata
directly, binning_pass and binning_pass_kv_cols in interpret mode at the
geometry tests/test_pallas_radix.py uses, and the LSD composition against
the JAX stable route.  On a CPU tensor the port runs the kernel's plain
version; csrc/binning.cu is checked against that plain version on the card
by chip_smoke.py.  Outputs must be equal bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu.ops import pallas_radix as pr
from gpu_radix_sort_tpu.ops import radix_sort as jrs
from gpu_radix_sort_tpu.utils.keygen import Pcg32
from gpu_radix_sort_tpu_torch.ops import binning as bn
from gpu_radix_sort_tpu_torch.utils import checks

TILE = 4096  # the JAX tests' small geometry
B_OUT = 2048


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("offset,width", [(0, 4), (28, 4), (5, 3), (8, 8)])
def test_tile_digit_sort_and_metadata_match_jax(offset, width):
    keys = Pcg32(state=width).fill(3 * TILE)
    keys[: TILE // 2] = 0xFFFFFFFF  # a tile that is mostly one run
    keys_t = keys.reshape(3, TILE)
    want_sorted, want_starts = pr.tile_digit_sort(jnp.asarray(keys_t), offset, width)
    got_sorted, got_starts = bn.tile_digit_sort(_t(keys_t), offset, width)
    assert got_sorted.dtype == torch.uint32 and got_starts.dtype == torch.int32
    np.testing.assert_array_equal(got_sorted.numpy(), np.asarray(want_sorted))
    np.testing.assert_array_equal(got_starts.numpy(), np.asarray(want_starts))
    want_g, want_s, _, _ = pr._binning_metadata(want_starts, TILE, B_OUT, 3 * TILE)
    got_g, got_s = bn._binning_metadata(got_starts, TILE)
    assert got_g.dtype == torch.int64 and got_s.dtype == torch.int64
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# Few cases: each new JAX geometry costs seconds of interpret-mode compile.
@pytest.mark.parametrize("n,offset,width", [(7, 0, 4), (1111, 8, 4), (4096, 28, 4),
                                            (6000, 5, 3)])
def test_binning_pass_matches_pallas(n, offset, width):
    keys = Pcg32().fill(n)
    want = np.asarray(pr.binning_pass(keys, offset, width, tile=TILE, b_out=B_OUT))
    got = bn.binning_pass(_t(keys), offset, width, tile=TILE)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)


def _skewed(case: str) -> np.ndarray:
    n = 4096 + 321
    if case == "all_same":
        return np.full(n, 0xDEADBEEF, dtype=np.uint32)
    if case == "two_vals":
        return np.where(np.arange(n) % 7 == 0, np.uint32(0xF0), np.uint32(0x0F)).astype(np.uint32)
    keys = np.sort(Pcg32().fill(n))
    return keys if case == "sorted" else keys[::-1].copy()


@pytest.mark.parametrize("case", ["all_same", "two_vals", "sorted", "rev"])
def test_binning_pass_skew_matches_pallas(case):
    keys = _skewed(case)
    for offset in (0, 4):
        want = np.asarray(pr.binning_pass(keys, offset, 4, tile=TILE, b_out=B_OUT))
        got = bn.binning_pass(_t(keys), offset, 4, tile=TILE)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,L", [(1, 1), (1111, 3), (6000, 2)])
def test_binning_pass_kv_cols_matches_pallas(n, L):
    keys = Pcg32().fill(n)
    lanes = np.arange(n * L, dtype=np.uint32).reshape(n, L)  # provenance
    cols = tuple(np.ascontiguousarray(lanes[:, w]) for w in range(L))
    want_k, want_c = pr.binning_pass_kv_cols(
        jnp.asarray(keys), tuple(jnp.asarray(c) for c in cols), 8, 4,
        tile=TILE, b_out=B_OUT,
    )
    got_k, got_c = bn.binning_pass_kv_cols(_t(keys), tuple(_t(c) for c in cols), 8, 4,
                                           tile=TILE)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    assert len(got_c) == L
    for g, w in zip(got_c, want_c):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("offset,width", [(0, 8), (4, 8), (0, 16), (9, 16), (3, 13)])
def test_sort_by_digits_large_matches_jax_stable_route(offset, width):
    keys = Pcg32(state=offset + width).fill(3 * TILE + 99)
    keys[::5] &= np.uint32(0xFFFF00FF)  # duplicate digits, distinct keys
    want = np.asarray(jrs.sort_by_digits(jnp.asarray(keys), offset, width, strategy="xla"))
    got = bn.sort_by_digits_large(_t(keys), offset, width, tile=TILE)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 7, TILE - 1, TILE, TILE + 1, 3 * TILE + 5])
def test_binning_pass_pads_ragged_tiles(n):
    keys = Pcg32(state=n).fill(n)
    keys[: n // 3] = 0xFFFFFFFF  # data equal to the pad value
    for offset, width in [(0, 4), (28, 4), (3, 8)]:
        got = bn.binning_pass(_t(keys), offset, width, tile=TILE)
        np.testing.assert_array_equal(got.numpy(), checks.partial_sort_oracle(keys, offset, width))


def test_kv_multipass_moves_columns_stably():
    n = 6000
    keys = Pcg32().fill(n)
    keys[::3] &= np.uint32(0xFFF00FFF)
    col = np.arange(n, dtype=np.uint32)
    got_k, (got_v,) = bn.sort_key_value_by_digits_large(_t(keys), (_t(col),), 4, 10, tile=TILE)
    order = np.argsort(checks.extract_digits(keys, 4, 10), kind="stable")
    np.testing.assert_array_equal(got_k.numpy(), keys[order])
    np.testing.assert_array_equal(got_v.numpy(), order.astype(np.uint32))


def test_geometry_and_what_the_kernel_takes():
    assert bn.PASS_WIDTH == 4 and bn.TILE == 1 << 15
    assert [bn.auto_geometry(n) for n in (0, 1, 5, bn.TILE, 1 << 28)] == [1, 1, 8, bn.TILE, bn.TILE]
    keys = _t(Pcg32().fill(2 * TILE))
    sk, cols, g_run, sflat = bn.stage_a(keys, (), 0, 4, TILE)
    assert cols == () and g_run.shape == (2 * 16 + 1,) and sflat.shape == (2 * 16,)
    assert int(g_run[-1]) == 2 * TILE
    before = bn.launches
    out = bn.bin_runs(sk, sk, g_run, sflat, TILE, 0, 4)
    assert bn.launches == before
    np.testing.assert_array_equal(out.numpy(), checks.partial_sort_oracle(keys.numpy(), 0, 4))
    with pytest.raises(ValueError, match="at most 8 bits"):
        bn.binning_pass(keys, 0, 9)
    with pytest.raises(ValueError, match="whole number of tiles"):
        bn.bin_runs(sk, sk, g_run, sflat, TILE - 1, 0, 4)
    with pytest.raises(TypeError, match="g_run must be a contiguous int64"):
        bn.bin_runs(sk, sk, g_run.to(torch.int32), sflat, TILE, 0, 4)
    with pytest.raises(TypeError, match="sflat must be a contiguous int64"):
        bn.bin_runs(sk, sk, g_run, sflat[:-1], TILE, 0, 4)
    with pytest.raises(ValueError, match="payload column must be uint32"):
        bn.binning_pass_kv_cols(keys, (keys[:5],), 0, 4)
    assert bn.binning_pass(keys[:0], 0, 4).numel() == 0
