"""The port's mesh and collective exchanges (parallel/mesh.py,
parallel/exchange.py) vs the JAX package's exchange.py: the metadata math on
random (P, D) count matrices, and one round of the alltoall, overflow and
gather exchanges shard by shard, overflow flag included.  The JAX side runs
under shard_map on the virtual CPU devices with strategy="xla"; the port on
key_mesh([cpu] * P), where the kernels' plain versions run.  Keys are
integers: outputs must be equal bytes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as PS

from gpu_radix_sort_tpu.ops.radix_sort import sort_by_digits as jax_sort_by_digits
from gpu_radix_sort_tpu.parallel import distributed as jdist
from gpu_radix_sort_tpu.parallel import exchange as jex
from gpu_radix_sort_tpu.parallel import key_mesh as jax_key_mesh
from gpu_radix_sort_tpu.utils.keygen import Pcg32
from gpu_radix_sort_tpu_torch.ops.radix_sort import sort_by_digits
from gpu_radix_sort_tpu_torch.parallel import distributed as dist
from gpu_radix_sort_tpu_torch.parallel import exchange as ex
from gpu_radix_sort_tpu_torch.parallel import mesh as pm

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
    return np.sort(Pcg32(state=seed).fill(n))  # presorted


def count_matrices():
    rng = np.random.default_rng(7)
    yield "random", rng.integers(0, 50, size=(8, 16)).astype(np.int32)
    sparse = rng.integers(0, 50, size=(8, 16)).astype(np.int32)
    sparse[:, ::3] = 0  # empty digits
    sparse[2] = 0  # a rank with no keys of any digit
    yield "empty-digits", sparse
    one = np.zeros((8, 16), np.int32)
    one[:, 5] = 1000  # everything in one digit
    yield "one-digit", one
    yield "wide", rng.integers(0, 5, size=(4, 1 << 16)).astype(np.int32)


@pytest.mark.parametrize("name,counts", list(count_matrices()), ids=lambda v: v if isinstance(v, str) else "")
def test_run_starts_and_slice_counts_match_jax(name, counts):
    want_S = np.asarray(jex._run_starts_global(jnp.asarray(counts)))
    got_S = ex._run_starts_global(torch.from_numpy(counts))
    assert got_S.dtype == torch.int64
    np.testing.assert_array_equal(got_S.numpy(), want_S)
    total = int(counts.sum())
    bounds = sorted({0, 1, total // 3, total // 2, total - 1, total, total + 5})
    for i in range(counts.shape[0]):
        for b in bounds:
            want = int(jex._slice_counts(jnp.asarray(want_S[i]), jnp.asarray(counts[i]), b))
            got = ex._slice_counts(got_S[i], torch.from_numpy(counts[i]), b)
            assert int(got) == want, (i, b)
    # the broadcast form: all bounds and all ranks at once
    got_all = ex._slice_counts(got_S, torch.from_numpy(counts), torch.tensor(bounds)[:, None])
    for j, b in enumerate(bounds):
        for i in range(counts.shape[0]):
            want = int(jex._slice_counts(jnp.asarray(want_S[i]), jnp.asarray(counts[i]), b))
            assert int(got_all[j, i]) == want


def test_capacities_match_jax():
    for n_local in (1, 7, 64, 1000, 1 << 13, (1 << 16) + 3):
        for nchips in (1, 2, 3, 8, 64):
            for cf in (1.0, 1.25, 1.5):
                assert ex.default_capacity(n_local, nchips, cf) == jex.default_capacity(
                    n_local, nchips, cf)
            assert ex.overflow_capacities(n_local, nchips) == jex.overflow_capacities(
                n_local, nchips)


@pytest.mark.parametrize("dist_name", ["uniform", "dupes", "presorted"])
def test_round_metadata_matches_jax(dist_name):
    P, n, offset, width = 8, 1 << 13, 8, 8
    keys = keys_of(dist_name, n)

    def body(local):
        s = jax_sort_by_digits(local, offset, width, strategy="xla")
        _, bounds, send, recv = jex._round_metadata_sorted(s, offset, width, "x")
        return bounds, send, recv

    want = jax_shards(keys, P, body, 3)
    sorted_shards = [sort_by_digits(s, offset, width) for s in port_shards(keys, P)]
    for r, (bounds, send, recv) in enumerate(ex._round_metadata_sorted(sorted_shards, offset, width)):
        np.testing.assert_array_equal(bounds.numpy(), want[0][r])
        np.testing.assert_array_equal(send.numpy(), want[1][r])
        np.testing.assert_array_equal(recv.numpy(), want[2][r])


def _capacity(exchange, n_local, P):
    if exchange == "overflow":
        return ex.overflow_capacities(n_local, P)
    return ex.default_capacity(n_local, P, 1.25)


@pytest.mark.parametrize("dist_name", ["uniform", "dupes", "presorted"])
@pytest.mark.parametrize("exchange", ["alltoall", "overflow", "gather"])
def test_collective_round_matches_jax(exchange, dist_name):
    """One round (offset 0, width 8) at P = 8, n = 2^13: the new shards and
    the overflow flag of each rank equal JAX's _round_fn."""
    P, n, width = 8, 1 << 13, 8
    keys = keys_of(dist_name, n)
    capacity = _capacity(exchange, n // P, P)

    def body(local):
        return jdist._round_fn(local, offset=0, width=width, axis="x", exchange=exchange,
                               capacity=capacity, strategy="xla")

    want_keys, want_ovf = jax_shards(keys, P, body, 2)
    for strategy in (None, "torch"):
        got, ovf = dist._round_fn(port_shards(keys, P), offset=0, width=width,
                                  exchange=exchange, capacity=capacity, strategy=strategy)
        np.testing.assert_array_equal([bool(o) for o in ovf], want_ovf[:, 0])
        for r in range(P):
            assert got[r].dtype == torch.uint32
            np.testing.assert_array_equal(got[r].numpy(), want_keys[r], err_msg=f"rank {r}")
    if dist_name == "dupes" and exchange != "gather":
        assert want_ovf.any()  # the skewed case does overflow a capacity


@pytest.mark.parametrize("exchange", ["alltoall", "overflow"])
def test_collective_raw_exchange_matches_jax(exchange):
    """The raw form: tags (D on padding slots) and the flat receive buffer."""
    P, n, offset, width = 8, 1 << 13, 8, 8
    keys = keys_of("uniform", n, seed=9)
    capacity = _capacity(exchange, n // P, P)

    def body(local):
        s = jax_sort_by_digits(local, offset, width, strategy="xla")
        return jdist._exchange_raw(s, offset=offset, width=width, axis="x",
                                   exchange=exchange, capacity=capacity)

    want_tags, want_flat, want_ovf = jax_shards(keys, P, body, 3)
    sorted_shards = [sort_by_digits(s, offset, width) for s in port_shards(keys, P)]
    tags, flat, ovf = dist._exchange_raw(sorted_shards, offset=offset, width=width,
                                         exchange=exchange, capacity=capacity)
    for r in range(P):
        np.testing.assert_array_equal(tags[r].numpy(), want_tags[r])
        valid = want_tags[r] != (1 << width)
        np.testing.assert_array_equal(flat[r].numpy()[valid], want_flat[r][valid])
        assert bool(ovf[r]) == bool(want_ovf[r, 0])


def test_mesh_collectives():
    mesh = pm.key_mesh([CPU] * 3)
    assert mesh.shape == {"x": 3} and pm.axis_size(mesh) == 3 and mesh.size == 3
    x = torch.arange(12, dtype=torch.int32)
    shards = pm.shard(x, mesh)
    assert [s.tolist() for s in shards] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    np.testing.assert_array_equal(pm.unshard(shards).numpy(), x.numpy())
    for g in pm.all_gather(shards):
        np.testing.assert_array_equal(g.numpy(), x.view(3, 4).numpy())
    blocks = [torch.arange(3 * 2).view(3, 2) + 100 * i for i in range(3)]
    out = pm.all_to_all(blocks)
    for j in range(3):
        for i in range(3):
            np.testing.assert_array_equal(out[j][i].numpy(), blocks[i][j].numpy())
    assert int(pm.psum([torch.tensor(1), torch.tensor(2), torch.tensor(4)])) == 7
    with pytest.raises(ValueError, match="equal shards"):
        pm.shard(torch.arange(10), mesh)


def test_key_mesh_needs_cuda_or_explicit_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        pm.key_mesh()
    with pytest.raises(ValueError, match="at least one device"):
        pm.key_mesh([])
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        pm.key_mesh([torch.device("cpu"), torch.device("meta")])
    assert pm.key_mesh(["cpu", "cpu"]).devices == (CPU, CPU)
