"""64-bit sorts of the PyTorch port vs the JAX package: sort_full_u64,
sort_key_value_u64, sort_partial_u64 and sort_partial_counts_u64 (stable
and stable=False) over uint64, int64 and float64 keys.  Same numpy inputs,
made from a seed, to both sides; the port's results, brought back to numpy,
must be the JAX package's bytes.

The JAX functions are host-facing and run XLA sorts on the CPU, no Pallas
kernel.  B5 tiles are cut to SMALL_TILE keys so that each binning pass runs
many tiles; keys repeat so that stability shows."""

import numpy as np
import pytest
import torch

import gpu_radix_sort_tpu_torch as port
from gpu_radix_sort_tpu.ops import radix_sort as jrs
from gpu_radix_sort_tpu.utils.keygen import generate_payloads
from gpu_radix_sort_tpu_torch.ops import binning as bn
from gpu_radix_sort_tpu_torch.ops import radix_sort as rs

torch.set_num_threads(1)

N = 4099
SMALL_TILE = 256


@pytest.fixture(autouse=True)
def small_tiles(monkeypatch):
    """Many B5 tiles, and wide payload rows gathered in many chunks."""
    monkeypatch.setattr(bn, "TILE", SMALL_TILE)
    monkeypatch.setattr(rs, "GATHER_CHUNK", 256)


def _keys(dtype: str, n: int = N, seed: int = 31) -> np.ndarray:
    """Random 64-bit words with a repeated value every 7th row, the dtype's
    extremes and, for float64, +-0.0, +-inf and NaNs of both signs."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    keys = raw.view(dtype)
    if n < 8:
        return keys
    raw[::7] = raw[1]
    raw[:8] = [0, 1 << 63, 0x7FF0000000000000, 0xFFF0000000000000,
               0x7FF8000000000000, 0xFFF8000000000001, 1, (1 << 64) - 1]
    if dtype == "float64":  # finite values mostly, so that order shows
        keys[8:] = rng.standard_normal(n - 8) * 1e3
        keys[8::7] = keys[9]
    return keys


def _same(got: torch.Tensor, want: np.ndarray) -> None:
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), np.ascontiguousarray(want).view(np.uint8))


@pytest.mark.parametrize("dtype", ["uint64", "int64", "float64"])
def test_sort_full_u64_matches_jax(dtype):
    keys = _keys(dtype)
    _same(port.sort_full_u64(torch.from_numpy(keys)), jrs.sort_full_u64(keys))


def _payload(form: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(19)
    if form.startswith("lanes"):
        return rng.integers(0, 1 << 32, (n, int(form[5:])), dtype=np.uint64).astype(np.uint32)
    if form.startswith("rows"):
        return generate_payloads(n, payload_bytes=int(form[4:]))
    return {"u32": np.arange(n, dtype=np.uint32), "f32": rng.standard_normal(n).astype(np.float32),
            "u16": np.arange(n, dtype=np.uint16)}[form]


@pytest.mark.parametrize("form", ["lanes1", "lanes3", "lanes6", "u32", "f32", "u16",
                                  "rows8", "rows7"])
def test_sort_key_value_u64_payloads_match_jax(form):
    keys, values = _keys("uint64"), _payload(form, N)
    want_k, want_v = jrs.sort_key_value_u64(keys, values)
    got_k, got_v = port.sort_key_value_u64(torch.from_numpy(keys), torch.from_numpy(values))
    _same(got_k, want_k)
    _same(got_v, want_v)


@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_sort_key_value_u64_typed_keys_match_jax(dtype):
    keys, values = _keys(dtype), np.arange(N, dtype=np.uint32)
    want_k, want_v = jrs.sort_key_value_u64(keys, values)
    got_k, got_v = port.sort_key_value_u64(torch.from_numpy(keys), torch.from_numpy(values))
    _same(got_k, want_k)
    _same(got_v, want_v)


def _both_partials(keys: np.ndarray, offset: int, width: int, stable: bool) -> None:
    for jfn, pfn in ((jrs.sort_partial_u64, port.sort_partial_u64),
                     (jrs.sort_partial_counts_u64, port.sort_partial_counts_u64)):
        want_k, want_meta = jfn(keys, offset, width, stable=stable)
        got_k, got_meta = pfn(torch.from_numpy(keys), offset, width, stable=stable)
        _same(got_k, want_k)
        _same(got_meta, np.asarray(want_meta))


WINDOWS = [(0, 8), (28, 8), (32, 4), (48, 16), (60, 4), (5, 7), (31, 2)]


@pytest.mark.parametrize("offset,width", WINDOWS)
def test_sort_partial_u64_stable_matches_jax(offset, width):
    _both_partials(_keys("uint64"), offset, width, stable=True)


@pytest.mark.parametrize("offset,width", WINDOWS[:-1])
def test_sort_partial_u64_unstable_matches_jax(offset, width):
    _both_partials(_keys("uint64"), offset, width, stable=False)


@pytest.mark.parametrize("offset", [0, 16, 32])
def test_sort_partial_u64_whole_word_windows_match_jax(offset):
    """width 32: the digit is a whole 32-bit word (eight binning passes when
    stable; the word swap of the rotation when not).  Sorted keys and
    digits only: 2^32 boundaries are not a test's size."""
    keys = _keys("uint64")
    for stable in (True, False):
        shi, slo, sd = jrs._sort_partial_u64_impl(keys, offset, 32, stable)
        got_k, got_d = rs._sort_partial_u64_impl(torch.from_numpy(keys), offset, 32, stable)
        _same(got_k, jrs._words_to_np64(shi, slo, keys.dtype))
        _same(got_d, np.asarray(sd))


@pytest.mark.parametrize("dtype,offset,width,stable", [
    ("int64", 56, 8, True), ("int64", 28, 8, False),
    ("float64", 60, 4, False), ("float64", 0, 16, True)])
def test_sort_partial_u64_typed_keys_match_jax(dtype, offset, width, stable):
    _both_partials(_keys(dtype), offset, width, stable)


@pytest.mark.parametrize("n", [0, 1])
def test_u64_sorts_at_tiny_n_match_numpy(n):
    """n of 0 and 1, against numpy."""
    keys = _keys("uint64", n)
    _same(port.sort_full_u64(torch.from_numpy(keys)), np.sort(keys))
    got_k, got_v = port.sort_key_value_u64(torch.from_numpy(keys),
                                           torch.from_numpy(np.zeros((n, 3), np.uint8)))
    _same(got_k, keys)
    _same(got_v, np.zeros((n, 3), np.uint8))
    for stable in (True, False):
        got_k, counts = port.sort_partial_counts_u64(torch.from_numpy(keys), 60, 4, stable=stable)
        _same(got_k, keys)
        want = np.bincount((keys >> np.uint64(60)).astype(np.int64), minlength=16)
        _same(counts, want.astype(np.int32))


def test_u64_sorts_reject_bad_input():
    with pytest.raises(TypeError, match="uint64"):
        port.sort_full_u64(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError, match="uint64"):
        port.sort_key_value_u64(torch.zeros(4, dtype=torch.uint32), torch.zeros(4))
    with pytest.raises(ValueError, match="leading axis"):
        port.sort_key_value_u64(torch.zeros(4, dtype=torch.int64), torch.zeros(3))
    for offset, width in [(60, 8), (0, 33), (0, 0), (-1, 4)]:
        with pytest.raises(ValueError, match="64-bit digit range"):
            port.sort_partial_u64(torch.zeros(4, dtype=torch.int64), offset, width)
    with pytest.raises(TypeError, match="uint64"):
        port.sort_partial_counts_u64(torch.zeros(4, dtype=torch.uint32), 0, 4)
