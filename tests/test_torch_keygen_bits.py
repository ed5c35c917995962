"""PyTorch port vs the JAX package: PCG32 stream, Zipf keys and payloads,
bit helpers, the 32- and 64-bit key codecs and numpy oracles.  Same inputs
to both sides; outputs must be equal bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu.ops import bits as jbits
from gpu_radix_sort_tpu.utils import checks as jchecks
from gpu_radix_sort_tpu.utils import keygen as jkeygen
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


@pytest.mark.parametrize("s", [*range(33), 37])
def test_rotr32_matches_jax(s):
    """Every rotation in 0..31 (and two past 32), on the edge values and
    random keys: the int32 form gives the JAX package's bytes."""
    x = keygen.Pcg32(state=s + 1).fill(1000)
    x[:5] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    got = bits.rotr32(torch.from_numpy(x), s)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbits.rotr32(jnp.asarray(x), s)))


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


@pytest.mark.parametrize("n,alpha,universe,seed", [
    (0, 1.1, 2**32, 0), (5000, 1.1, 2**32, 0), (3000, 1.3, 2**32, 3), (2000, 2.0, 1000, 9)])
def test_generate_zipf_keys_match_jax(n, alpha, universe, seed):
    got = keygen.generate_zipf_keys(n, alpha=alpha, universe=universe, seed=seed)
    want = jkeygen.generate_zipf_keys(n, alpha=alpha, universe=universe, seed=seed)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,payload_bytes,seed", [(0, 8, 1), (1000, 64, 1), (777, 7, 5)])
def test_generate_payloads_match_jax(n, payload_bytes, seed):
    got = keygen.generate_payloads(n, payload_bytes=payload_bytes, seed=seed)
    want = jkeygen.generate_payloads(n, payload_bytes=payload_bytes, seed=seed)
    assert got.dtype == np.uint8 and got.shape == (n, payload_bytes)
    np.testing.assert_array_equal(got, want)


def _words64(n: int = 2000) -> np.ndarray:
    raw = np.random.default_rng(64).integers(0, 1 << 64, n, dtype=np.uint64)
    raw[:12] = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1,
                0x8000000000000001,  # -0.0 / INT64_MIN and its neighbours
                0x7FF0000000000000, 0xFFF0000000000000,  # +inf, -inf
                0x7FF8000000000000, 0xFFF8000000000000,  # +NaN, -NaN
                0x7FF0000000000001, 0xFFF0000000000001]  # NaNs with payloads
    return raw


@pytest.mark.parametrize("s", [0, 1, 17, 31, 32, 33, 63, 64, 100])
def test_rotr64_lanes_match_jax(s):
    raw = _words64()
    hi = (raw >> np.uint64(32)).astype(np.uint32)
    lo = (raw & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want_hi, want_lo = jbits.rotr64_lanes(jnp.asarray(hi), jnp.asarray(lo), s)
    got_hi, got_lo = bits.rotr64_lanes(torch.from_numpy(hi), torch.from_numpy(lo), s)
    np.testing.assert_array_equal(got_hi.numpy(), np.asarray(want_hi))
    np.testing.assert_array_equal(got_lo.numpy(), np.asarray(want_lo))
    # the int64 form the unstable 64-bit partial sorts rotate with
    rot = bits.rotr64(torch.from_numpy(raw.view(np.int64)), s).numpy().view(np.uint64)
    want = (np.asarray(want_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(want_lo)
    np.testing.assert_array_equal(rot, want)


@pytest.mark.parametrize("dtype", ["uint64", "int64", "float64"])
def test_encode_decode_ordered64_match_jax(dtype):
    """The torch codec's sortable int64, as the bits of the encoded word
    (``^ 1 << 63``), is the JAX package's ``encode_ordered_np64``; the
    port's numpy codec too; an int64 sort of it is numpy's totalOrder sort;
    the (hi, lo) words and the digits of the encoded word agree."""
    x = _words64().view(dtype)
    want = jbits.encode_ordered_np64(x)
    s = bits.encode_ordered64(torch.from_numpy(x))
    assert s.dtype == torch.int64
    np.testing.assert_array_equal(s.numpy().view(np.uint64) ^ np.uint64(1 << 63), want)
    np.testing.assert_array_equal(bits.encode_ordered_np64(x), want)
    dec = bits.decode_ordered64(s, getattr(torch, dtype)).numpy()
    assert dec.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(dec.view(np.uint64), x.view(np.uint64))
    np.testing.assert_array_equal(bits.decode_ordered_np64(want, dtype).view(np.uint64),
                                  jbits.decode_ordered_np64(want, dtype).view(np.uint64))
    np.testing.assert_array_equal(np.sort(s.numpy()).view(np.uint64) ^ np.uint64(1 << 63),
                                  np.sort(want))
    hi, lo = bits.split_words(s)
    np.testing.assert_array_equal(hi.numpy(), (want >> np.uint64(32)).astype(np.uint32))
    np.testing.assert_array_equal(lo.numpy(), (want & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    assert torch.equal(bits.join_words(hi, lo), s)
    for offset, width in ((0, 32), (28, 8), (60, 4), (5, 7)):
        np.testing.assert_array_equal(
            bits.digits64(s, offset, width).numpy(),
            ((want >> np.uint64(offset)) & np.uint64((1 << width) - 1)).astype(np.uint32))
    with pytest.raises(TypeError, match="unsupported key dtype"):
        bits.encode_ordered64(torch.zeros(3, dtype=torch.int32))
