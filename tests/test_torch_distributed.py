"""Slice three of the PyTorch port as a whole vs the JAX package: the mesh
LSD sort (sort_distributed, build_distributed_sort) through every exchange,
fused and unfused loops, skewed and typed keys, the argument checks,
DistributedSortPipeline and the CLI's ``sort --mode mesh``.  The JAX side
runs on the 8 virtual CPU devices with its collective exchanges and
strategy="xla" (never its Pallas remote-DMA kernels); the port on
key_mesh([cpu] * 8), where the kernels' plain versions run.  Keys are
integers: outputs must be equal bytes."""

import functools

import jax
import numpy as np
import pytest
import torch

import gpu_radix_sort_tpu_torch as port
from gpu_radix_sort_tpu.models.pipelines import (
    DistributedSortPipeline as JaxDistributedSortPipeline,
)
from gpu_radix_sort_tpu.parallel import distributed as jdist
from gpu_radix_sort_tpu.parallel import key_mesh as jax_key_mesh
from gpu_radix_sort_tpu.utils.keygen import Pcg32
from gpu_radix_sort_tpu_torch.cli import main as port_cli
from gpu_radix_sort_tpu_torch.ops import binning as bn
from gpu_radix_sort_tpu_torch.ops import block_sort as bs
from gpu_radix_sort_tpu_torch.ops import digit_sort as ds
from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
from gpu_radix_sort_tpu_torch.parallel import distributed as dist
from gpu_radix_sort_tpu_torch.parallel import mesh as pm
from gpu_radix_sort_tpu_torch.parallel import rdma_exchange as rx
from gpu_radix_sort_tpu_torch.parallel import rdma_overlap as ov

P = 8
CPU_MESH = pm.key_mesh([torch.device("cpu")] * P)
EXCHANGES = ["gather", "alltoall", "overflow", "rdma", "rdma_overlap"]


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


def _jax_mesh():
    return jax_key_mesh(jax.devices("cpu"))


@functools.lru_cache(maxsize=None)
def _jax_sorted(n: int, width: int, ranks: int = P) -> bytes:
    keys = Pcg32(state=n).fill(n)
    mesh = jax_key_mesh(jax.devices("cpu")[:ranks])
    out = jdist.sort_distributed(keys, mesh=mesh, width=width, exchange="gather",
                                 strategy="xla")
    return np.asarray(out).tobytes()


# (exchange, width, n, ranks): widths 8 and 16 at every n on 8 ranks; the
# narrow widths (more of the fused loops' rotations, 8 to 32 rounds) and 3
# ranks at a few n, so that the JAX references stay few.  The exchanges with
# fixed per-peer slots (alltoall, overflow) overflow by design once a digit
# has fewer buckets than there are ranks, so they take width 4 alone.
MESH_CASES = [
    (e, w, n, P)
    for e in EXCHANGES for w in (8, 16) if (e, w) != ("rdma_overlap", 16)
    for n in (1, 7, 1111, 4099, 1 << 13, 1 << 15)
] + [
    (e, w, 1111, P) for w in (1, 2, 4) for e in EXCHANGES
    if w == 4 or e not in ("alltoall", "overflow")
] + [
    (e, w, n, 3) for e in EXCHANGES for w, n in ((8, 7), (8, 4099), (4, 1111))
]


def _mesh_case_id(case) -> str:
    exchange, width, n, ranks = case
    return f"{exchange}-{width}-{n}" + ("" if ranks == P else f"-P{ranks}")


@pytest.mark.parametrize("exchange,width,n,ranks", MESH_CASES,
                         ids=[_mesh_case_id(c) for c in MESH_CASES])
def test_sort_distributed_matches_jax(exchange, width, n, ranks):
    keys = Pcg32(state=n).fill(n)
    mesh = CPU_MESH if ranks == P else pm.key_mesh([torch.device("cpu")] * ranks)
    got = port.sort_distributed(torch.from_numpy(keys), mesh=mesh, width=width,
                                exchange=exchange)
    assert got.dtype == torch.uint32 and got.shape == (n,)
    assert got.numpy().tobytes() == _jax_sorted(n, width, ranks)
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("exchange", ["alltoall", "overflow", "rdma"])
def test_fused_and_unfused_loops_give_identical_bytes(exchange, width):
    n_local = 1 << 10
    keys = Pcg32(state=width).fill(P * n_local)
    keys[::1000] = keys[0]  # ties across shards
    outs = []
    for fuse in (True, False):
        fn = port.build_distributed_sort(CPU_MESH, n_local, width=width, exchange=exchange,
                                         fuse_rounds=fuse)
        shards, overflow = fn(pm.shard(torch.from_numpy(keys), CPU_MESH))
        assert int(overflow) == 0
        outs.append(pm.unshard(shards).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], np.sort(keys))


@pytest.mark.parametrize("exchange", ["gather", "rdma", "rdma_overlap", "auto"])
def test_all_equal_keys_are_exact(exchange):
    keys = np.full(1 << 12, 0xDEADBEEF, dtype=np.uint32)
    got = port.sort_distributed(torch.from_numpy(keys), mesh=CPU_MESH, exchange=exchange)
    np.testing.assert_array_equal(got.numpy(), keys)


@pytest.mark.parametrize("exchange", ["alltoall", "overflow"])
def test_capacity_overflow_raises_like_jax(exchange):
    keys = np.full(1 << 12, 7, dtype=np.uint32)
    with pytest.raises(jdist.OverflowError_):
        jdist.sort_distributed(keys, mesh=_jax_mesh(), width=8, exchange=exchange,
                               capacity_factor=1.0, strategy="xla")
    with pytest.raises(dist.OverflowError_, match="capacity overflowed"):
        port.sort_distributed(torch.from_numpy(keys), mesh=CPU_MESH, width=8,
                              exchange=exchange, capacity_factor=1.0)


def test_auto_falls_back_to_gather_on_overflow(monkeypatch):
    """Above 2^20 keys "auto" means alltoall; all-equal keys overflow it and
    the sort reruns through gather.  The threshold is lowered here so the
    test stays small."""
    built = []
    real = dist.build_distributed_sort

    def spy(mesh, n_local, **kw):
        built.append(kw["exchange"])
        return real(mesh, n_local, **kw)

    monkeypatch.setattr(dist, "build_distributed_sort", spy)
    keys = np.full((1 << 20) + 8, 0xABCD0123, dtype=np.uint32)
    got = port.sort_distributed(torch.from_numpy(keys), mesh=CPU_MESH, exchange="auto")
    np.testing.assert_array_equal(got.numpy(), keys)
    assert built == ["auto", "gather"]


@pytest.mark.parametrize("exchange", ["rdma", "rdma_overlap", "alltoall"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_typed_keys_match_jax(dtype, exchange):
    raw = Pcg32(state=7).fill(5000)
    raw[:6] = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00001, 0xFFC00000]
    keys = raw.view(dtype)
    want = jdist.sort_distributed(keys, mesh=_jax_mesh(), exchange="gather", strategy="xla")
    got = port.sort_distributed(torch.from_numpy(keys), mesh=CPU_MESH, exchange=exchange)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want).view(np.uint32))
    got_np = port.sort_distributed(keys, mesh=CPU_MESH, exchange=exchange)  # numpy input
    np.testing.assert_array_equal(got_np.numpy().view(np.uint32), np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("kwargs", [
    dict(width=5), dict(width=32), dict(exchange="bogus"),
    dict(exchange="gather", fuse_rounds=True),
    dict(exchange="rdma_overlap", fuse_rounds=True),
    dict(exchange="rdma_overlap", width=16),
], ids=["width5", "width32", "exchange", "fuse-gather", "fuse-overlap", "overlap-width16"])
def test_build_rejects_what_jax_rejects(kwargs):
    with pytest.raises(ValueError):
        jdist.build_distributed_sort(_jax_mesh(), 1024, **kwargs)
    with pytest.raises(ValueError):
        port.build_distributed_sort(CPU_MESH, 1024, **kwargs)


def test_build_checks_its_own_arguments():
    with pytest.raises(ValueError, match="strategy must be one of"):
        port.build_distributed_sort(CPU_MESH, 1024, strategy="xla")
    fn = port.build_distributed_sort(CPU_MESH, 1024, exchange="rdma")
    with pytest.raises(ValueError, match="shards of 1024 keys"):
        fn(pm.shard(torch.zeros(P * 512, dtype=torch.uint32), CPU_MESH))
    # rdma takes any n_local: the receive buffers are exact, no 128-lane rows
    fn = port.build_distributed_sort(CPU_MESH, 1000, exchange="rdma")
    keys = Pcg32(state=1).fill(P * 1000)
    shards, overflow = fn(pm.shard(torch.from_numpy(keys), CPU_MESH))
    assert int(overflow) == 0
    np.testing.assert_array_equal(pm.unshard(shards).numpy(), np.sort(keys))
    with pytest.raises(TypeError, match="unsupported key dtype"):
        port.sort_distributed(torch.zeros(4, dtype=torch.int64), mesh=CPU_MESH)


def test_distributed_pipeline_matches_jax():
    n_local = 1 << 10
    fn, (example,) = port.DistributedSortPipeline(n_local=n_local, mesh=CPU_MESH).build()
    jfn, (jexample,) = JaxDistributedSortPipeline(n_local=n_local, mesh=_jax_mesh()).build()
    np.testing.assert_array_equal(pm.unshard(example).numpy(), np.asarray(jexample))
    shards, overflow = fn(example)
    jout, joverflow = jfn(jexample)
    assert int(overflow) == int(joverflow) == 0
    np.testing.assert_array_equal(pm.unshard(shards).numpy(), np.asarray(jout))
    # algorithm="sample": PSRS, the same counts and valid prefixes as JAX's,
    # and JAX's ValueError on a strategy or an exchange
    fn, (example,) = port.DistributedSortPipeline(
        algorithm="sample", n_local=n_local, mesh=CPU_MESH).build()
    jfn, (jexample,) = JaxDistributedSortPipeline(
        algorithm="sample", n_local=n_local, mesh=_jax_mesh()).build()
    buffers, counts, overflow = fn(example)
    jbuffers, jcounts, joverflow = jfn(jexample)
    assert int(overflow) == int(joverflow) == 0
    jcounts, jbuffers = np.asarray(jcounts), np.asarray(jbuffers).reshape(P, -1)
    np.testing.assert_array_equal(pm.unshard(counts).numpy(), jcounts)
    for r in range(P):
        np.testing.assert_array_equal(buffers[r][:jcounts[r]].numpy(), jbuffers[r, :jcounts[r]])
    for kwargs in ({"strategy": "torch"}, {"exchange": "rdma"}):
        with pytest.raises(ValueError, match="ignores strategy/exchange"):
            port.DistributedSortPipeline(algorithm="sample", mesh=CPU_MESH, **kwargs).build()
        with pytest.raises(ValueError, match="ignores strategy/exchange"):
            JaxDistributedSortPipeline(algorithm="sample", mesh=_jax_mesh(), **kwargs).build()


def test_cli_sort_mode_mesh(tmp_path, capsys):
    keys_file, out = tmp_path / "keys.bin", tmp_path / "sorted.bin"
    assert port_cli(["gen", "--n", "5000", "--out", str(keys_file)]) == 0
    for exchange in ("rdma", "rdma_overlap"):
        assert port_cli(["sort", "--in", str(keys_file), "--mode", "mesh", "--device", "cpu",
                         "--width", "8", "--exchange", exchange, "--verify",
                         "--out", str(out)]) == 0
        assert "EXACT MATCH" in capsys.readouterr().err
        keys = np.fromfile(keys_file, dtype=np.uint32)
        np.testing.assert_array_equal(np.fromfile(out, dtype=np.uint32), np.sort(keys))


def test_cpu_tensors_launch_nothing():
    counters = (rx, ov, bs, ms, ds, bn)
    before = [m.launches for m in counters]
    keys = torch.from_numpy(Pcg32().fill(1 << 14))
    for exchange in ("rdma", "rdma_overlap"):
        port.sort_distributed(keys, mesh=CPU_MESH, exchange=exchange)
    assert [m.launches for m in counters] == before


def test_default_mesh_is_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = Pcg32().fill(100)
    for call in (lambda: port.sort_distributed(keys),
                 lambda: port.sort_distributed(torch.from_numpy(keys)),
                 lambda: port.key_mesh(),
                 lambda: port.DistributedSortPipeline(n_local=64).build()):
        with pytest.raises(RuntimeError, match="none is available"):
            call()
