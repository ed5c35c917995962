"""The port's ragged exchanges (B6, parallel/rdma_exchange.py; B7,
parallel/rdma_overlap.py) vs the JAX package.  The JAX package's own plain
reference for its remote-DMA exchanges is its collective exchange with the
same contract (tests/test_distributed.py holds the two equal on the JAX
side), so the port is held against ``exchange_round_alltoall[_raw]`` at
capacity n_local: the receive sequence of the raw form (JAX's flat where
tags != D) and the reassembled round.  These tests never run JAX's Pallas
remote-DMA kernels.  On CPU tensors the port's wrappers run their plain
versions; the CUDA kernels are held against those on the card by
chip_smoke.py.  Keys are integers: outputs must be equal bytes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as PS

from gpu_radix_sort_tpu.ops.radix_sort import sort_by_digits as jax_sort_by_digits
from gpu_radix_sort_tpu.parallel import exchange as jex
from gpu_radix_sort_tpu.parallel import key_mesh as jax_key_mesh
from gpu_radix_sort_tpu.utils.keygen import Pcg32
from gpu_radix_sort_tpu_torch.ops import binning as bn
from gpu_radix_sort_tpu_torch.ops.boundaries import digit_counts_sorted
from gpu_radix_sort_tpu_torch.ops.radix_sort import sort_by_digits
from gpu_radix_sort_tpu_torch.parallel import mesh as pm
from gpu_radix_sort_tpu_torch.parallel import rdma_exchange as rx
from gpu_radix_sort_tpu_torch.parallel import rdma_overlap as ov

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread each keeps torch's thread pools from oversubscribing the cores
    (with one pool thread a core, a round's many small metadata ops run
    several times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_shards(keys: np.ndarray, P: int, body, nout: int) -> list:
    """body(local) under shard_map over the first P virtual CPU devices;
    each of its nout outputs comes back as a numpy array (P, -1)."""
    mesh = jax_key_mesh(jax.devices("cpu")[:P])
    fn = jax.jit(shard_map(
        lambda x: tuple(jnp.atleast_1d(o) for o in body(x)), mesh=mesh,
        in_specs=PS("x"), out_specs=(PS("x"),) * nout, check_vma=False,
    ))
    outs = fn(jax.device_put(keys, NamedSharding(mesh, PS("x"))))
    return [np.asarray(o).reshape(P, -1) for o in outs]


def port_shards(keys: np.ndarray, P: int) -> list:
    return pm.shard(torch.from_numpy(keys), pm.key_mesh([CPU] * P))


def keys_of(dist_name: str, n: int, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dist_name == "uniform":
        return Pcg32(state=seed).fill(n)
    if dist_name == "dupes":  # 4 distinct keys
        return rng.integers(0, 4, size=n).astype(np.uint32)
    if dist_name == "skewed":  # as tests/test_distributed.py:165
        return (rng.zipf(1.3, size=n) % (1 << 16)).astype(np.uint32) << np.uint32(8)
    return np.sort(Pcg32(state=seed).fill(n))  # presorted


def jax_alltoall_round(keys, P, offset, width):
    n_local = keys.size // P

    def body(local):
        return jex.exchange_round_alltoall(local, offset, width, "x", n_local, strategy="xla")

    return jax_shards(keys, P, body, 2)[0]


# ---------------------------------------------------------------------------
# B6: schedule, wrapper, raw exchange and round
# ---------------------------------------------------------------------------

def _count_matrices():
    """(P, D) digit counts of P shards of n_local keys each."""
    rng = np.random.default_rng(3)
    yield rng.multinomial(300, np.full(16, 1 / 16), size=8).astype(np.int32)
    p = np.zeros(16)
    p[::2] = 1 / 8  # empty digits
    yield rng.multinomial(300, p, size=8).astype(np.int32)
    m = np.zeros((4, 256), np.int32)
    m[:, 7] = 512  # everything in one digit: every rank sends to one peer in turn
    yield m
    yield rng.multinomial(500, np.full(64, 1 / 64), size=1).astype(np.int32)


@pytest.mark.parametrize("counts", list(_count_matrices()), ids=["random", "empty-digits", "one-digit", "one-rank"])
def test_send_matrix_matches_jax_closed_form(counts):
    """M[src, dst] as rdma_exchange.py:234-244 derives it from JAX's
    _run_starts_global and _slice_counts; every rank sends and receives
    exactly n_local keys."""
    P = counts.shape[0]
    n_local = int(counts.sum()) // P
    S = jex._run_starts_global(jnp.asarray(counts))
    below = jax.vmap(
        lambda b: jax.vmap(lambda S_i, c_i: jex._slice_counts(S_i, c_i, b))(S, jnp.asarray(counts))
    )(jnp.arange(P + 1) * n_local)
    want = np.asarray(below[1:] - below[:-1]).T
    got = rx.send_matrix(torch.from_numpy(counts), n_local)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.sum(0).numpy(), np.full(P, n_local))
    np.testing.assert_array_equal(got.sum(1).numpy(), counts.sum(1))
    for i in range(P):
        src_start, count, rank, dst_start = rx.segments(got, i).numpy()
        np.testing.assert_array_equal(count, want[i])
        np.testing.assert_array_equal(src_start, np.cumsum(want[i]) - want[i])
        np.testing.assert_array_equal(rank, np.arange(P))
        np.testing.assert_array_equal(dst_start, want[:i].sum(0))


def _numpy_segment_copy(src, segs, recv):
    for s0, count, rank, d0 in segs.T:
        for k in range(count):
            recv[rank][d0 + k] = src[s0 + k]


@pytest.mark.parametrize("wrapper", [rx.segment_copy, rx.segment_copy_plain, rx.segment_copy_emulated])
def test_segment_copy_matches_a_numpy_loop(wrapper):
    src = Pcg32(state=4).fill(100)
    segs = np.array([
        [0, 10, 10, 40, 40, 100],   # src_start (ascending, disjoint)
        [10, 0, 30, 0, 60, 0],      # count, with empty segments
        [2, 0, 0, 1, 2, 1],         # dst_rank
        [5, 0, 0, 3, 15, 63],       # dst_start
    ], dtype=np.int64)
    want = [np.zeros(n, np.uint32) for n in (30, 64, 75)]
    _numpy_segment_copy(src, segs, want)
    got = [torch.zeros(n, dtype=torch.uint32) for n in (30, 64, 75)]
    before = rx.launches
    wrapper(torch.from_numpy(src), torch.from_numpy(segs), got)
    assert rx.launches == before  # CPU tensors launch nothing
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("dst_shift", range(4))
@pytest.mark.parametrize("src_shift", range(4))
def test_segment_walk_matches_plain_at_every_alignment(src_shift, dst_shift):
    """segment_copy_kernel's walk (segment_copy_emulated) at every word
    offset of the source and of the receivers past a 16-byte boundary:
    heads, aligned and lagged vectors and tails, empty segments, and blocks
    of 32 keys that cut segments, against the plain version."""
    src = torch.from_numpy(Pcg32(state=4).fill(300))
    segs = torch.tensor([
        [0, 3, 3, 9, 40, 41, 110, 200, 300],   # src_start (ascending, disjoint)
        [3, 0, 5, 31, 1, 66, 90, 97, 0],       # count, with empty segments
        [2, 0, 1, 0, 2, 1, 0, 2, 1],           # dst_rank
        [1, 0, 6, 0, 4, 11, 31, 5, 77],        # dst_start
    ], dtype=torch.int64)
    sizes = (121, 80, 102)
    want = [torch.zeros(n, dtype=torch.uint32) for n in sizes]
    rx.segment_copy_plain(src, segs, want)
    got = [torch.zeros(n, dtype=torch.uint32) for n in sizes]
    shifts = [(dst_shift + c) % 4 for c in range(3)]
    stats = rx.segment_copy_emulated(src, segs, got, src_shift=src_shift, dst_shifts=shifts, chunk=32)
    for c, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"receiver {c}")
    assert stats["vectors"] > 0 and stats["head"] > 0 and stats["tail"] > 0 and stats["cut"] > 0
    assert stats["lagged"] <= stats["vectors"]  # lagged where the staged words are off by 1-3
    assert stats["head"] + 4 * stats["vectors"] + stats["tail"] == int(segs[1].sum())


@pytest.mark.parametrize("P", [1, 4])
def test_segment_walk_matches_plain_on_real_schedules(P):
    """The schedules a round builds from real digit counts, one launch a
    sender, with the kernel's own chunk and with one that cuts segments."""
    n = 1 << 13
    shards = [sort_by_digits(s, 8, 8) for s in port_shards(keys_of("skewed", n, seed=P), P)]
    M = rx.send_matrix(torch.stack([digit_counts_sorted(s, 8, 8) for s in shards]), n // P)
    for i, s in enumerate(shards):
        segs = rx.segments(M, i)
        want = [torch.zeros(n // P, dtype=torch.uint32) for _ in range(P)]
        rx.segment_copy_plain(s, segs, want)
        for chunk in (rx.COPY_CHUNK, 256):
            got = [torch.zeros(n // P, dtype=torch.uint32) for _ in range(P)]
            rx.segment_copy_emulated(s, segs, got, src_shift=i % 4,
                                     dst_shifts=[(i + c + 1) % 4 for c in range(P)], chunk=chunk)
            for c in range(P):
                np.testing.assert_array_equal(got[c].numpy(), want[c].numpy(), err_msg=f"{i} -> {c}")


def test_segment_copy_rejects_what_the_kernel_does_not_take():
    src = torch.zeros(8, dtype=torch.uint32)
    recv = [torch.zeros(8, dtype=torch.uint32)]
    good = torch.tensor([[0], [8], [0], [0]], dtype=torch.int64)
    with pytest.raises(TypeError, match="contiguous \\(4, S\\) int64"):
        rx.segment_copy(src, good.to(torch.int32), recv)
    with pytest.raises(TypeError, match="contiguous \\(4, S\\) int64"):
        rx.segment_copy(src, good[:3], recv)
    with pytest.raises(TypeError, match="uint32"):
        rx.segment_copy(src.view(torch.int32), good, recv)
    with pytest.raises(ValueError, match="receivers"):
        rx.segment_copy(src, good, recv * (rx.MAX_RANKS + 1))


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("P", [8, 1])
def test_rdma_raw_receive_sequence_matches_jax_alltoall_raw(P, width):
    """Rank c's exact receive buffer equals JAX's capacity-n_local
    all-to-all receive buffer with its padding slots (tags == D) dropped;
    the port's tags are the plain digits (no slack)."""
    n, offset = 1 << 13, width
    keys = keys_of("uniform", n, seed=P + width)
    D = 1 << width

    def body(local):
        s = jax_sort_by_digits(local, offset, width, strategy="xla")
        tags, flat, _ = jex.exchange_round_alltoall_raw(s, offset, width, "x", n // P)
        return tags, flat

    want_tags, want_flat = jax_shards(keys, P, body, 2)
    sorted_shards = [sort_by_digits(s, offset, width) for s in port_shards(keys, P)]
    tags, flat, ovf = rx.exchange_round_rdma_raw(sorted_shards, offset, width)
    for r in range(P):
        valid = want_tags[r] != D
        assert flat[r].numel() == n // P == valid.sum()
        np.testing.assert_array_equal(flat[r].numpy(), want_flat[r][valid])
        np.testing.assert_array_equal(tags[r].numpy(), want_tags[r][valid])
        assert not bool(ovf[r])


@pytest.mark.parametrize("dist_name", ["uniform", "dupes", "presorted", "skewed"])
def test_rdma_round_matches_jax_alltoall_round(dist_name):
    P, n, offset, width = 8, 1 << 13, 8, 8
    keys = keys_of(dist_name, n)
    want = jax_alltoall_round(keys, P, offset, width)
    for strategy in (None, "torch"):
        got, ovf = rx.exchange_round_rdma(port_shards(keys, P), offset, width, strategy=strategy)
        for r in range(P):
            np.testing.assert_array_equal(got[r].numpy(), want[r], err_msg=f"rank {r}")
        assert not any(bool(o) for o in ovf)


# ---------------------------------------------------------------------------
# B7: the overlapped round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist_name", ["uniform", "skewed"])
@pytest.mark.parametrize("tile", [1024, 2048])
def test_rdma_overlapped_round_matches_jax_alltoall_round(tile, dist_name):
    """P = 4, n_local = 4096: G = 4 or 2 groups a rank.  The overlapped and
    the serial mode both equal JAX's all-to-all round."""
    P, n, offset, width = 4, 1 << 14, 8, 8
    keys = keys_of(dist_name, n, seed=tile)
    want = jax_alltoall_round(keys, P, offset, width)
    before = (rx.launches, ov.launches, bn.launches)
    for serial in (False, True):
        got, ovf = ov.exchange_round_rdma_overlapped(
            port_shards(keys, P), offset, width, tile=tile, serial=serial)
        for r in range(P):
            np.testing.assert_array_equal(got[r].numpy(), want[r], err_msg=f"rank {r} serial={serial}")
        assert not any(bool(o) for o in ovf)
    assert (rx.launches, ov.launches, bn.launches) == before


def test_overlap_schedule_places_every_key_once():
    """start / dst_start tile each group's sorted keys and each receive
    buffer exactly, in (source, group) order."""
    P, tile = 4, 1024
    keys = keys_of("skewed", P * 3 * tile, seed=1)
    shards = port_shards(keys, P)
    hists = pm.all_gather([ov._group_hist(s, 8, 4, tile) for s in shards])[0]
    assert hists.shape == (P, 3, 16)
    start, dst_start = ov.overlap_schedule(hists, 3 * tile)
    for i in range(P):
        segs = ov.group_segments(torch.stack([start[i], dst_start[i]]), tile).numpy()
        assert segs[1].min() >= 0 and segs[1].sum() == 3 * tile
        np.testing.assert_array_equal(segs[0], np.cumsum(segs[1]) - segs[1])
    for c in range(P):
        lens = (torch.cat([start[:, :, 1:], torch.full((P, 3, 1), tile)], 2) - start)[:, :, c]
        np.testing.assert_array_equal(dst_start[:, :, c].reshape(-1).numpy(),
                                      np.cumsum(lens.reshape(-1).numpy()) - lens.reshape(-1).numpy())


def test_group_sorts_match_numpy():
    tile, offset, width = 1024, 3, 5
    keys = keys_of("skewed", 4 * tile, seed=2) ^ Pcg32(state=2).fill(4 * tile)
    x = torch.from_numpy(keys)
    got = ov.group_sort(x, tile, offset, width).numpy().reshape(-1, tile)
    for g, row in enumerate(keys.reshape(-1, tile)):
        d = (row >> offset) & ((1 << width) - 1)
        np.testing.assert_array_equal(got[g], row[np.argsort(d, kind="stable")])


def test_overlap_rejects_what_it_does_not_take():
    shards = port_shards(Pcg32().fill(4 * 2048), 4)
    with pytest.raises(ValueError, match="width <= 8"):
        ov.exchange_round_rdma_overlapped(shards, 0, 9, tile=1024)
    with pytest.raises(ValueError, match="power of two"):
        ov.exchange_round_rdma_overlapped(shards, 0, 8, tile=1536)
    with pytest.raises(ValueError, match="power of two"):
        ov.exchange_round_rdma_overlapped(shards, 0, 8, tile=512)
    with pytest.raises(ValueError, match="multiple of tile"):
        ov.exchange_round_rdma_overlapped(port_shards(Pcg32().fill(4 * 3072), 4), 0, 8, tile=2048)
    x = torch.from_numpy(Pcg32().fill(2048))
    with pytest.raises(ValueError, match="widths <= 8"):
        ov.group_sort(x, 1024, 0, 9)
    with pytest.raises(TypeError, match="sched must be"):
        ov.group_sort_send(x, 1024, 0, 8, torch.zeros((2, 2, 3), dtype=torch.int64),
                           [torch.zeros(8, dtype=torch.uint32)] * 2)


def test_pick_tile():
    assert ov.pick_tile(1024) == 1024
    assert ov.pick_tile(3 * 2048) == 2048
    assert ov.pick_tile(1 << 20) == ov.MAX_TILE == 1 << 14
    assert ov.pick_tile(5 * (1 << 15)) == 1 << 14
    for n in (1000, 512, 3 * 512):
        with pytest.raises(ValueError, match="power-of-two factor"):
            ov.pick_tile(n)
