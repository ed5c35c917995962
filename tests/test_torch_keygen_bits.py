"""PyTorch port vs the JAX package: PCG32 stream, bit helpers, key codecs
and numpy oracles.  Same inputs to both sides; outputs must be equal
bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu.ops import bits as jbits
from gpu_radix_sort_tpu.utils import checks as jchecks
from gpu_radix_sort_tpu.utils.keygen import Pcg32 as JaxPcg32
from gpu_radix_sort_tpu_torch.ops import bits
from gpu_radix_sort_tpu_torch.utils import checks, keygen


@pytest.mark.parametrize(
    "state,n",
    [(int(keygen.PCG32_INIT_STATE), 0), (int(keygen.PCG32_INIT_STATE), 1),
     (int(keygen.PCG32_INIT_STATE), 4099), (12345, 1000), (2**64 - 1, 257)],
)
def test_pcg32_fill_matches_jax(state, n):
    port, ref = keygen.Pcg32(state), JaxPcg32(state)
    for chunk in (n, 3, 1000):  # the stream continues across calls
        np.testing.assert_array_equal(port.fill(chunk), ref.fill(chunk))
    assert port.state == ref.state


def test_generate_keys_continues_the_global_stream():
    keygen.reset_global_stream()
    got = np.concatenate([keygen.generate_keys(100), keygen.generate_keys(50)])
    keygen.reset_global_stream()
    np.testing.assert_array_equal(got, JaxPcg32().fill(150))
    np.testing.assert_array_equal(keygen.generate_keys(150), got)
    keygen.reset_global_stream()


def _typed_keys(dtype: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 1 << 32, 4000, dtype=np.uint32)
    specials = np.array(
        [0x00000000, 0x80000000,  # +0, -0 (float) / 0, INT_MIN (int)
         0x7F800000, 0xFF800000,  # +inf, -inf
         0x7FC00000, 0xFFC00000,  # +NaN, -NaN
         0x7FC00001, 0xFF800001,  # NaNs with payloads
         0x00000001, 0x80000001, 0x7FFFFFFF, 0xFFFFFFFF],
        dtype=np.uint32,
    )
    return np.concatenate([raw, specials]).view(dtype)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_encode_decode_ordered_match_jax(dtype):
    x = _typed_keys(dtype)
    enc = bits.encode_ordered(torch.from_numpy(x)).numpy()
    want = np.asarray(jbits.encode_ordered(jnp.asarray(x)))
    np.testing.assert_array_equal(enc, want)
    dec = bits.decode_ordered(torch.from_numpy(enc), getattr(torch, dtype)).numpy()
    assert dec.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(dec.view(np.uint32), x.view(np.uint32))
    jdec = np.asarray(jbits.decode_ordered(jnp.asarray(want), jnp.dtype(dtype)))
    np.testing.assert_array_equal(dec.view(np.uint32), jdec.view(np.uint32))


def test_encode_ordered_uint32_is_identity_and_rejects_other_dtypes():
    x = torch.from_numpy(np.array([0, 7, 0xFFFFFFFF], np.uint32))
    assert bits.encode_ordered(x) is x
    assert bits.decode_ordered(x, torch.uint32) is x
    with pytest.raises(TypeError, match="unsupported key dtype"):
        bits.encode_ordered(torch.zeros(3, dtype=torch.float64))
    with pytest.raises(TypeError, match="unsupported key dtype"):
        bits.decode_ordered(x, torch.int64)


@pytest.mark.parametrize("s", [0, 1, 8, 16, 31, 32, 37])
def test_rotr32_matches_jax(s):
    x = keygen.Pcg32(state=s + 1).fill(1000)
    x[:3] = [0, 1, 0xFFFFFFFF]
    got = bits.rotr32(torch.from_numpy(x), s).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbits.rotr32(jnp.asarray(x), s)))


@pytest.mark.parametrize(
    "offset,width", [(0, 8), (8, 8), (24, 8), (0, 32), (31, 1), (3, 13)]
)
def test_extract_digits_matches_jax(offset, width):
    x = keygen.Pcg32(state=offset * 64 + width).fill(1000)
    got = bits.extract_digits(torch.from_numpy(x), offset, width)
    assert got.dtype == torch.uint32
    want = np.asarray(jbits.extract_digits(jnp.asarray(x), offset, width))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("offset,width", [(0, 0), (30, 4), (-1, 4), (0, 33)])
def test_validate_digit_range_rejects_like_jax(offset, width):
    with pytest.raises(ValueError):
        jbits.validate_digit_range(offset, width)
    with pytest.raises(ValueError, match="digit range"):
        bits.validate_digit_range(offset, width)


@pytest.mark.parametrize("offset,width", [(0, 4), (8, 8), (28, 4), (0, 1), (3, 12), (16, 16)])
def test_oracles_match_jax(offset, width):
    keys = keygen.Pcg32(state=99).fill(3000)
    keys[:50] = 0xFFFFFFFF
    digit_sorted = jchecks.partial_sort_oracle(keys, offset, width)
    np.testing.assert_array_equal(
        checks.partial_sort_oracle(keys, offset, width), digit_sorted
    )
    for sorted_keys in (digit_sorted, digit_sorted[5:], digit_sorted[:0]):
        np.testing.assert_array_equal(
            checks.boundaries_oracle(sorted_keys, offset, width),
            jchecks.boundaries_oracle(sorted_keys, offset, width),
        )
    fully = np.sort(keys)
    for result in (fully, fully[::-1], digit_sorted):
        assert checks.check_sort_full(result, keys) == jchecks.check_sort_full(result, keys)
        assert checks.check_partial(result, keys, offset, width) == \
            jchecks.check_partial(result, keys, offset, width)
        assert checks.check_partial_groups(result, keys, offset, width) == \
            jchecks.check_partial_groups(result, keys, offset, width)
        assert checks.check_sorted(result) == jchecks.check_sorted(result)
    counts = checks.true_bucket_counts(keys, offset, width)
    np.testing.assert_array_equal(counts, jchecks.true_bucket_counts(keys, offset, width))
    b = checks.boundaries_oracle(digit_sorted, offset, width)
    np.testing.assert_array_equal(
        checks.bucket_counts_from_boundaries(b, keys.size),
        jchecks.bucket_counts_from_boundaries(b, keys.size),
    )
