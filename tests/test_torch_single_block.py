"""The one-block sort (B3, ops/single_block.py): the register network of
csrc/register_bitonic.cuh emulated in torch step for step
(``network_emulated``: 16 slots a thread, strides 1-8 in a thread, 16-256
across lanes, 512 and up through shared memory, pads of 0xFFFFFFFF) and held
against numpy's sort, the port's plain version and the JAX package's
``pallas_sort.sort_full`` in interpret mode.  The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py.  Keys are integers:
outputs must be equal bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu.ops import pallas_sort
from gpu_radix_sort_tpu.utils.keygen import Pcg32
from gpu_radix_sort_tpu_torch.ops import block_sort as bs
from gpu_radix_sort_tpu_torch.ops import single_block as sb


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the emulation's many small ops run
    tens of times slower with a pool thread a core in each of the suite's
    worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def keys_of(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if kind == "random":
        return Pcg32(state=n).fill(n)
    if kind == "duplicate":  # four values, among them both ends of the range
        return np.array([0, 7, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)[rng.integers(0, 4, n)]
    if kind == "all-max":
        return np.full(n, 0xFFFFFFFF, np.uint32)
    if kind == "all-zero":
        return np.zeros(n, np.uint32)
    return np.sort(Pcg32(state=n).fill(n))[::-1].copy()  # descending


@pytest.mark.parametrize("kind", ["random", "duplicate", "all-max", "all-zero", "descending"])
@pytest.mark.parametrize("n", [1, 2, 17, 511, 512, 1000, 1024, 4099, 8192, sb.MAX_N - 3, sb.MAX_N])
def test_network_emulated_matches_numpy(n, kind):
    keys = keys_of(kind, n)
    got = sb.network_emulated(torch.from_numpy(keys))
    assert got.dtype == torch.uint32 and got.numel() == n
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))
    np.testing.assert_array_equal(got.numpy(), sb.sort_single_block(torch.from_numpy(keys)).numpy())


@pytest.mark.parametrize("kind", ["random", "duplicate", "all-max"])
@pytest.mark.parametrize("n", [1, 1000, 4099])
def test_network_emulated_matches_pallas_sort_full(n, kind):
    keys = keys_of(kind, n)
    want = np.asarray(pallas_sort.sort_full(jnp.asarray(keys)))
    np.testing.assert_array_equal(sb.network_emulated(torch.from_numpy(keys)).numpy(), want)


@pytest.mark.parametrize("reg_log,counts", [
    (4, {"thread": 50, "lane": 40, "shared": 15}),
    (5, {"thread": 60, "lane": 35, "shared": 10}),
    (6, {"thread": 69, "lane": 30, "shared": 6}),
])
def test_network_schedule_places_each_stride(reg_log, counts):
    """Phase p runs strides 2^(p-1) down to 1; a stride below 2^reg_log
    stays in a thread, below 32 times that in a warp, and only larger ones
    cross warps, one barrier each: at 2^14 keys and 16 keys a thread, 15 of
    the 105 stages."""
    for log in range(reg_log + bs.LANE_LOG, 15):
        schedule = bs.network_schedule(log, reg_log)
        assert len(schedule) == log * (log + 1) // 2
        for p in range(1, log + 1):
            assert [j for q, j, _ in schedule if q == p] == list(range(p - 1, -1, -1))
        kinds = [kind for _, _, kind in schedule]
        got = {k: kinds.count(k) for k in ("thread", "lane", "shared")}
        assert got["thread"] == sum(min(p, reg_log) for p in range(1, log + 1))
        assert got["shared"] == sum(max(p - reg_log - 5, 0) for p in range(1, log + 1))
        for _, j, kind in schedule:
            keys_apart = 1 << j
            assert kind == ("thread" if keys_apart < 1 << reg_log
                            else "lane" if keys_apart < 32 << reg_log else "shared")
    assert got == counts


@pytest.mark.parametrize("n,log", [(1, 9), (512, 9), (513, 10), (4096, 12), (4097, 13), (sb.MAX_N, 14)])
def test_network_spans_a_whole_warp_at_least(n, log):
    assert sb.network_log(n) == log
    assert sb.network_log(n, 6) == max(log, 11)


@pytest.mark.parametrize("reg_log", [5, 6])
@pytest.mark.parametrize("n", [1, 1000, 2048, 4099, sb.MAX_N])
def test_network_emulated_at_other_keys_a_thread(reg_log, n):
    """The geometries tools/network_variants.py times: 32 and 64 keys a
    thread, on duplicate-heavy keys with both ends of the range."""
    keys = keys_of("duplicate", n)
    got = sb.network_emulated(torch.from_numpy(keys), reg_log)
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))


def test_pads_sort_last_and_are_never_returned():
    """A ragged n fills the network with 0xFFFFFFFF; keys of all ones tie
    with the pads and the first n slots are still exactly the sorted keys."""
    keys = np.array([0xFFFFFFFF, 3, 0xFFFFFFFF, 0, 2] * 205, np.uint32)
    got = sb.network_emulated(torch.from_numpy(keys)).numpy()
    assert got.size == keys.size
    np.testing.assert_array_equal(got, np.sort(keys))


def test_single_block_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="one block sorts at most"):
        sb.sort_single_block(torch.zeros(sb.MAX_N + 1, dtype=torch.uint32))
    with pytest.raises(TypeError, match="uint32"):
        sb.sort_single_block(torch.zeros(8, dtype=torch.int32))
    assert sb.sort_single_block(torch.zeros(0, dtype=torch.uint32)).numel() == 0
