"""Table operators of the PyTorch port (ops/table.py) vs the JAX package's
ops/table.py: hash_u32, hash_partition_ids, partition_by_ids, pack_by_mask,
compact, filter_range, group_aggregate_sorted and group_aggregate.  Same
inputs to both sides, made from a seed; outputs must be equal bytes.

The one exception is the float sum a CUDA tensor takes
(:func:`ops.table.segment_sum_scan`, a fixed-order tree where the JAX
package adds serially): run here on CPU tensors, it is held against a
float64 numpy sum to a relative 1e-5 (its error is about log2(run length)
float32 roundings, ~2e-6 here) and must give the same bytes on every call.

The JAX functions run XLA on the CPU, no Pallas kernel.  B5 tiles are cut
to SMALL_TILE keys so that each binning pass runs many tiles, and the rows
of the two-level running max to 64 elements."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu.ops import table as jt
from gpu_radix_sort_tpu.utils.keygen import Pcg32, generate_zipf_keys
from gpu_radix_sort_tpu_torch.ops import binning as bn
from gpu_radix_sort_tpu_torch.ops import table as pt

torch.set_num_threads(1)

N = 3000
SMALL_TILE = 256
FLOAT_SUM_RTOL = 1e-5


@pytest.fixture(autouse=True)
def small_tiles(monkeypatch):
    """Many B5 tiles, and many rows in the two-level running max of min and
    max and of the float sum's run starts."""
    monkeypatch.setattr(bn, "TILE", SMALL_TILE)
    monkeypatch.setattr(pt, "CUMMAX_ROW", 64)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


def _same(got: torch.Tensor, want) -> None:
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8),
                                  np.atleast_1d(want).view(np.uint8))


def _keys(n: int = N) -> np.ndarray:
    keys = Pcg32(state=5).fill(n)
    keys[:5] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    return keys


def test_hash_u32_matches_jax():
    keys = _keys(1 << 14)
    _same(pt.hash_u32(_t(keys)), jt.hash_u32(jnp.asarray(keys)))
    assert np.unique(pt.hash_u32(_t(keys)).numpy()).size == np.unique(keys).size


@pytest.mark.parametrize("nparts", [1, 2, 8, 256])
def test_hash_partition_ids_match_jax(nparts):
    keys = _keys()
    got = pt.hash_partition_ids(_t(keys), nparts)
    _same(got, jt.hash_partition_ids(jnp.asarray(keys), nparts))


@pytest.mark.parametrize("nparts", [1, 4, 6, 256])
def test_partition_by_ids_matches_jax(nparts):
    """Hash ids for powers of two; ids of a non-power-of-two count take the
    next width of digit."""
    keys = _keys()
    if nparts & (nparts - 1):
        ids = (keys % nparts).astype(np.uint32)
    else:
        ids = np.asarray(jt.hash_partition_ids(jnp.asarray(keys), nparts))
    want_r, want_c = jt.partition_by_ids(jnp.asarray(keys), jnp.asarray(ids), nparts)
    got_r, got_c = pt.partition_by_ids(_t(keys), _t(ids), nparts)
    _same(got_r, want_r)
    _same(got_c, want_c)


def test_pack_by_mask_matches_jax():
    keys = _keys()
    rng = np.random.default_rng(3)
    floats = rng.standard_normal(N).astype(np.float32)
    shorts = rng.integers(-1000, 1000, N).astype(np.int16)
    mask = (keys % 5) < 2
    want = jt.pack_by_mask(jnp.asarray(mask), jnp.asarray(keys), jnp.asarray(floats),
                           jnp.asarray(shorts))
    got = pt.pack_by_mask(_t(mask), _t(keys), _t(floats), _t(shorts))
    count = int(want[-1])
    _same(got[-1], want[-1])
    for g, w in zip(got[:-1], want[:-1]):
        _same(g[:count], np.asarray(w)[:count])


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_compact_matches_jax(density):
    keys = _keys()
    mask = np.random.default_rng(4).random(N) < density
    want_p, want_c = jt.compact(jnp.asarray(keys), jnp.asarray(mask))
    got_p, got_c = pt.compact(_t(keys), _t(mask))
    _same(got_c, want_c)
    _same(got_p[:int(want_c)], np.asarray(want_p)[:int(want_c)])
    assert got_p.shape == keys.shape  # static shape


@pytest.mark.parametrize("lo,hi", [(1 << 30, 3 << 30), (0, 0xFFFFFFFF), (5, 5)])
def test_filter_range_matches_jax(lo, hi):
    keys = _keys()
    want_p, want_c = jt.filter_range(jnp.asarray(keys), lo, hi)
    got_p, got_c = pt.filter_range(_t(keys), lo, hi)
    _same(got_c, want_c)
    _same(got_p[:int(want_c)], np.asarray(want_p)[:int(want_c)])


# float32 bit patterns: quiet NaNs of two payloads and both signs, a
# signalling NaN of each sign, zeros of both signs and the infinities
NANS = np.array([0x7FC00000, 0xFFC00001, 0x7FC01234, 0x7F8CFC76, 0xFF8CFC77], np.uint32)
ZEROS_INFS = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000], np.uint32)


def _values(dtype: str, n: int, keys: np.ndarray | None = None) -> np.ndarray:
    """Values for keys in [0, 50).  float32 with ``keys``: groups 0-9 hold
    NaNs among the other values, groups 10-14 zeros of both signs, groups
    15-19 zeros and infinities, group 20 only zeros and group 21 only -0.0
    (so that a zero is their min or max)."""
    rng = np.random.default_rng(7)
    if dtype == "float32":
        values = (rng.random(n) * 100).astype(np.float32)
        if keys is not None:
            bits = values.view(np.uint32)
            pick = np.random.default_rng(11).random(n) < 0.3
            for rows, pool in (((keys < 10) & pick, NANS),
                               ((keys >= 10) & (keys < 15) & pick, ZEROS_INFS[:2]),
                               ((keys >= 15) & (keys < 20) & pick, ZEROS_INFS),
                               (keys == 20, ZEROS_INFS[:2]), (keys == 21, ZEROS_INFS[1:2])):
                bits[rows] = pool[np.arange(rows.sum()) % pool.size]
        return values
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, n, dtype=np.int64).astype(dtype)


_jit_aggregate = jax.jit(jt.group_aggregate, static_argnames="op")


@pytest.mark.parametrize("op", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "uint32", "int32", "uint8", "int16"])
def test_group_aggregate_matches_jax(dtype, op):
    """Heavy duplicates (50 keys); full-range integers, so that sums wrap
    and a signed compare would show; float32 NaNs (quiet and signalling, of
    both signs), zeros of both signs and infinities, whose min and max must
    be the JAX package's bits."""
    keys = np.random.default_rng(8).integers(0, 50, N).astype(np.uint32)
    values = _values(dtype, N, keys)
    want = _jit_aggregate(jnp.asarray(keys), jnp.asarray(values), op=op)
    got = pt.group_aggregate(_t(keys), _t(values), op=op)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("n", [1, 2, 1000])
def test_float_min_max_of_random_bits_match_jax(n, op):
    """Random float32 bit patterns (a NaN in about one row of 256, runs
    with several), subnormals left out (see the next test): the bits of
    every row equal the JAX package's, one element alone included."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    subnormal = (bits & 0x7F800000) == 0
    bits[subnormal] &= 0x80000000
    keys = np.sort(np.arange(n, dtype=np.uint32) % 37)
    values = bits.view(np.float32)
    want = _jit_aggregate(jnp.asarray(keys), jnp.asarray(values), op=op)
    got = pt.group_aggregate(_t(keys), _t(values), op=op)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_float_subnormals_are_kept_like_numpy(op):
    """XLA on the CPU flushes float32 subnormals to zero in group sum, min
    and max (for [1e-40, 2e-40] it returns 0.0); CUDA keeps them, and so
    does the port on every device: it agrees with numpy there."""
    tiny = np.float32(1e-40)
    values = np.array([tiny, 2 * tiny, -tiny, 3 * tiny, 5.0, -2 * tiny], np.float32)
    keys = np.array([0, 0, 1, 1, 2, 2], np.uint32)
    starts = np.array([0, 2, 4])
    reduce = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
    want = reduce.reduceat(values, starts)
    assert (np.abs(want[:2]) < np.finfo(np.float32).tiny).all() and want[:2].all()
    _, got, count = pt.group_aggregate_sorted(_t(keys), _t(values), op)
    assert int(count) == 3
    _same(got[:3], want)
    jax_agg = np.asarray(jt.group_aggregate_sorted(jnp.asarray(keys), jnp.asarray(values), op)[1])
    assert not jax_agg[:2].any()  # the reference's platform flushes them


@pytest.mark.parametrize("op", ["count", "sum"])
def test_group_aggregate_keys_only_matches_jax(op):
    """values=None: keys only, through sort_full; Zipf-skewed keys."""
    keys = generate_zipf_keys(20000, alpha=1.3, seed=3)
    want = jt.group_aggregate(jnp.asarray(keys), None, op)
    got = pt.group_aggregate(_t(keys), None, op)
    for g, w in zip(got, want):
        _same(g, w)


def test_group_aggregate_sorted_takes_hash_clustered_runs():
    keys = np.array([7, 1, 4, 9, 2], dtype=np.uint32)
    order = np.argsort(np.asarray(jt.hash_u32(jnp.asarray(keys))).astype(np.int64))
    clustered = np.repeat(keys[order], 3)
    values = np.arange(clustered.size, dtype=np.uint32)
    want = jt.group_aggregate_sorted(jnp.asarray(clustered), jnp.asarray(values), "sum")
    got = pt.group_aggregate_sorted(_t(clustered), _t(values), "sum")
    for g, w in zip(got, want):
        _same(g, w)
    assert int(got[2]) == keys.size


def test_group_aggregate_rejects_bad_ops_and_takes_no_rows():
    keys = torch.zeros(4, dtype=torch.uint32)
    with pytest.raises(ValueError, match="op"):
        pt.group_aggregate(keys, None, "median")
    with pytest.raises(ValueError, match="requires explicit values"):
        pt.group_aggregate_sorted(keys, None, "min")
    with pytest.raises(ValueError, match="power of 2"):
        pt.hash_partition_ids(keys, 6)
    uniq, agg, count = pt.group_aggregate(torch.zeros(0, dtype=torch.uint32), None, "count")
    assert uniq.numel() == agg.numel() == 0 and int(count) == 0 and count.dtype == torch.int32


def test_cpu_float_sum_adds_each_run_serially_like_jax():
    """The JAX package's float sum (``segment_sum``, XLA's scatter-add on
    the CPU) adds each run's values one by one in index order from 0.0;
    the port's CPU path (``index_add_``) gives the same bytes, also with
    several intra-op threads."""
    rng = np.random.default_rng(10)
    keys = np.sort(rng.integers(0, 7, 500)).astype(np.uint32)
    values = (rng.standard_normal(500) * 1e4).astype(np.float32)
    starts = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
    serial = np.zeros(keys.size, np.float32)
    for g, (a, b) in enumerate(zip(starts, np.append(starts[1:], keys.size))):
        acc = np.float32(0.0)
        for v in values[a:b]:
            acc = np.float32(acc + v)
        serial[g] = acc
    want = jt.group_aggregate_sorted(jnp.asarray(keys), jnp.asarray(values), "sum")[1]
    _same(torch.from_numpy(serial), want)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        got = pt.group_aggregate_sorted(_t(keys), _t(values), "sum")[1]
    finally:
        torch.set_num_threads(threads)
    _same(got, serial)


@pytest.mark.parametrize("case", ["zipf", "one_run", "all_distinct"])
def test_card_float_sum_is_deterministic_and_close(case):
    """The float sum of a CUDA tensor, here on CPU tensors: within
    FLOAT_SUM_RTOL of float64 numpy sums, the same bytes on a second call,
    and 0 past the last run."""
    rng = np.random.default_rng(9)
    keys = {"zipf": np.sort(generate_zipf_keys(N, alpha=1.1, seed=1)),
            "one_run": np.zeros(N, np.uint32),
            "all_distinct": np.arange(N, dtype=np.uint32)}[case]
    values = (rng.random(N) * 100).astype(np.float32)
    starts = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
    is_start = torch.zeros(N, dtype=torch.bool)
    is_start[starts] = True
    got = pt.segment_sum_scan(_t(values), is_start)
    again = pt.segment_sum_scan(_t(values), is_start)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = np.add.reduceat(values.astype(np.float64), starts)
    np.testing.assert_allclose(got.numpy()[:starts.size], want, rtol=FLOAT_SUM_RTOL)
    assert not got.numpy()[starts.size:].any()
