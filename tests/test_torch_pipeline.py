"""The distributed hash aggregate of the PyTorch port
(``parallel/pipeline.py``, ``HashAggregatePipeline``, the CLI ``selftest``)
vs the JAX package's ``parallel/pipeline.py``.  The same numpy-seeded input
goes through JAX's mesh of the first P of its 8 CPU devices and the port's
``[cpu] * P``.

``build_hash_aggregate`` is compared rank by rank: the overflow count, each
rank's group count and the valid prefix of its group keys and aggregates,
byte for byte (rows past a rank's count are not part of the contract).  The
host entry is compared whole.  Float values hold ties and signed zeros and
no subnormals, which XLA on the CPU flushes and the port keeps
(``ops/table.py``).

The JAX sides run XLA sorts on the CPU, no Pallas kernel.  B5 tiles are cut
so that the key-value sorts run many tiles, and the JAX functions are
cached by shape so that its compiles stay few."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from gpu_radix_sort_tpu.models.pipelines import HashAggregatePipeline as JaxHashAggregatePipeline
from gpu_radix_sort_tpu.parallel import distributed as jdist
from gpu_radix_sort_tpu.parallel import key_mesh as jax_key_mesh
from gpu_radix_sort_tpu.parallel import pipeline as jp
from gpu_radix_sort_tpu.utils.keygen import generate_zipf_keys
from gpu_radix_sort_tpu_torch import HashAggregatePipeline
from gpu_radix_sort_tpu_torch.cli import main as port_cli
from gpu_radix_sort_tpu_torch.ops import binning as bn
from gpu_radix_sort_tpu_torch.ops import table as pt
from gpu_radix_sort_tpu_torch.parallel import mesh as pm
from gpu_radix_sort_tpu_torch.parallel import pipeline as pp
from gpu_radix_sort_tpu_torch.parallel.distributed import OverflowError_

N_LOCAL = 512
SMALL_TILE = 256
PAD_HASH_KEY = 0x2FA441F7  # the key whose hash is HASH_PAD (0xFFFFFFFF)


@pytest.fixture(autouse=True)
def _small_geometry(monkeypatch):
    """One intra-op thread (the suite runs in several processes), B5 tiles
    of SMALL_TILE keys, and short rows of the two-level running max."""
    monkeypatch.setattr(bn, "TILE", SMALL_TILE)
    monkeypatch.setattr(pt, "CUMMAX_ROW", 64)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def even_keys(k):
    """Keeps even keys: the same expression on JAX's uint32 keys and the
    port's int64 ones."""
    return (k & 1) == 0


def no_keys(k):
    return k < 0


@functools.lru_cache(maxsize=None)
def _jax_mesh(P: int):
    return jax_key_mesh(jax.devices("cpu")[:P])


@functools.lru_cache(maxsize=None)
def _jax_fn(P: int, n_local: int, op: str, predicate, factor: float):
    return jp.build_hash_aggregate(_jax_mesh(P), n_local, op=op, predicate=predicate,
                                   capacity_factor=factor)


def _jax_put(a: np.ndarray, P: int):
    return jax.device_put(a, NamedSharding(_jax_mesh(P), PartitionSpec("x")))


def _port_put(a: np.ndarray, P: int) -> list:
    n_local = a.shape[0] // P
    return [torch.from_numpy(a[r * n_local:(r + 1) * n_local].copy()) for r in range(P)]


def _keys(n: int, seed: int = 0) -> np.ndarray:
    """Zipf(1.2) keys (a hot key on every rank, duplicates across ranks)
    with full-range keys spread in: 0, 0xFFFFFFFF and the key that hashes
    to 0xFFFFFFFF."""
    keys = generate_zipf_keys(n, alpha=1.2, seed=seed + 3)
    keys[::17] = 0xFFFFFFFF
    keys[5::23] = 0
    keys[7::29] = PAD_HASH_KEY
    return keys


def _values(n: int, dtype: str, seed: int = 0) -> np.ndarray:
    """Values with ties; float32 with signed zeros, no subnormals."""
    rng = np.random.default_rng(seed + 7)
    if dtype == "uint32":
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    if dtype == "int32":
        return rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    vals = (rng.integers(-8, 8, n) * 0.25).astype(np.float32)
    vals[::5] = np.float32(-0.0)
    vals[3::31] = np.float32(3e38)
    return vals


def _row_valid(n: int, pad: int = 13) -> np.ndarray:
    """Every row valid but a scatter and the last ``pad`` (the host entry's
    padding)."""
    valid = np.ones(n, bool)
    valid[3::11] = False
    valid[n - pad:] = False
    return valid


def _same_ranks(P, port_out, jax_out) -> None:
    """The same overflow count; if none, the same group counts, and each
    rank's valid group keys and aggregates equal byte for byte."""
    gk, ga, ng, overflow = port_out
    jk, ja, jng, jov = (np.asarray(x) for x in jax_out)
    assert int(overflow) == int(jov)
    if int(jov):
        return
    counts = jng.reshape(-1)
    np.testing.assert_array_equal(pm.unshard(ng).numpy(), counts)
    assert ng[0].dtype == torch.int32
    for got, want in ((gk, jk), (ga, ja)):
        want = want.reshape(P, -1)
        for r in range(P):
            g, w = got[r][:counts[r]].numpy(), want[r, :counts[r]]
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def _compare_build(P, keys, vals, valid, op, predicate=None, factor=2.0):
    n_local = keys.size // P
    jfn, jcap = _jax_fn(P, n_local, op, predicate, factor)
    jax_out = jfn(_jax_put(keys, P), _jax_put(vals, P), _jax_put(valid, P))
    fn, cap = pp.build_hash_aggregate(pm.key_mesh([torch.device("cpu")] * P), n_local, op=op,
                                      predicate=predicate, capacity_factor=factor)
    assert cap == jcap
    port_out = fn(_port_put(keys, P), _port_put(vals, P), _port_put(valid, P))
    _same_ranks(P, port_out, jax_out)
    return port_out


OPS = [("count", "uint32")] + [(op, dtype) for op in ("sum", "min", "max")
                               for dtype in ("uint32", "int32", "float32")]


@pytest.mark.parametrize("op,dtype", OPS)
def test_build_hash_aggregate_matches_jax(op, dtype):
    n = 8 * N_LOCAL
    keys = _keys(n)
    vals = keys if op == "count" else _values(n, dtype)
    _compare_build(8, keys, vals, _row_valid(n), op)


@pytest.mark.parametrize("P", [1, 3])
def test_build_hash_aggregate_on_fewer_ranks_matches_jax(P):
    n = P * N_LOCAL
    keys = _keys(n, seed=P)
    _compare_build(P, keys, _values(n, "float32", seed=P), _row_valid(n), "sum")


@pytest.mark.parametrize("op", ["count", "sum"])
def test_build_hash_aggregate_with_a_predicate_matches_jax(op):
    n = 8 * N_LOCAL
    keys = _keys(n, seed=1)
    vals = keys if op == "count" else _values(n, "float32", seed=1)
    gk, _, ng, _ = _compare_build(8, keys, vals, _row_valid(n), op, predicate=even_keys)
    for k, c in zip(gk, ng):
        assert not (k[:int(c)].numpy() & 1).any()


@pytest.mark.parametrize("how", ["row_valid", "predicate"])
def test_build_hash_aggregate_of_an_all_filtered_input_matches_jax(how):
    n = 8 * N_LOCAL
    keys = _keys(n, seed=2)
    valid = np.zeros(n, bool) if how == "row_valid" else np.ones(n, bool)
    _, _, ng, overflow = _compare_build(
        8, keys, _values(n, "float32", seed=2), valid, "max",
        predicate=no_keys if how == "predicate" else None)
    assert int(overflow) == 0 and not pm.unshard(ng).any()


def _overflowing_keys(n_local: int, P: int) -> np.ndarray:
    """Rank 0 holds n_local distinct keys, every other rank one key: the
    splitters are the single keys' hashes, so rank 0's slices fall at
    random points of its hash order, and one outgrows a small capacity."""
    rng = np.random.default_rng(4)
    keys = np.repeat(rng.integers(0, 1 << 32, P, dtype=np.uint64).astype(np.uint32), n_local)
    keys[:n_local] = rng.choice(1 << 32, n_local, replace=False).astype(np.uint32)
    return keys


def test_build_hash_aggregate_overflows_where_jax_does():
    P, n_local = 8, 1024
    keys = _overflowing_keys(n_local, P)
    _, _, _, overflow = _compare_build(P, keys, keys, np.ones(keys.size, bool), "count",
                                       factor=1.0)
    assert int(overflow) == 1


def test_hash_aggregate_distributed_overflow_raises_where_jax_does():
    keys = _overflowing_keys(1024, 8)
    with pytest.raises(jdist.OverflowError_):
        jp.hash_aggregate_distributed(keys, op="count", capacity_factor=1.0)
    with pytest.raises(OverflowError_):
        pp.hash_aggregate_distributed(keys, op="count", capacity_factor=1.0,
                                      mesh=pm.key_mesh([torch.device("cpu")] * 8))


@pytest.mark.parametrize("op,dtype,n", [("count", None, 3001), ("sum", "float32", 2999),
                                        ("min", "uint32", 63), ("max", "int32", 0)])
def test_hash_aggregate_distributed_matches_jax(op, dtype, n):
    """Padding to the mesh (n not a multiple of 8; fewer rows than ranks
    squared; no rows), the rank-major join, the output dtypes."""
    keys = _keys(n, seed=n)
    vals = None if dtype is None else _values(n, dtype, seed=n)
    want = jp.hash_aggregate_distributed(keys, vals, op=op)
    got = pp.hash_aggregate_distributed(keys, vals, op=op,
                                        mesh=pm.key_mesh([torch.device("cpu")] * 8))
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("route", ["host", "device"])
def test_key_order_equals_np_unique(route, monkeypatch):
    """key_order=True gives np.unique's presentation through either route:
    np.argsort on the host below KEY_ORDER_DEVICE_MIN groups, sort_key_value
    on the mesh's first device from it."""
    monkeypatch.setattr(pp, "KEY_ORDER_DEVICE_MIN", 1 << 30 if route == "host" else 1)
    calls = []
    for name in ("_key_order_host", "_key_order_device"):
        real = getattr(pp, name)
        monkeypatch.setattr(pp, name, lambda k, a, real=real, name=name: (
            calls.append(name), real(k, a))[1])
    keys = _keys(5000, seed=9)
    gk, gc = pp.hash_aggregate_distributed(keys, op="count", key_order=True,
                                           mesh=pm.key_mesh([torch.device("cpu")] * 4))
    uk, uc = np.unique(keys, return_counts=True)
    np.testing.assert_array_equal(gk, uk)
    np.testing.assert_array_equal(gc.astype(np.int64), uc)
    assert calls == [f"_key_order_{route}"]


def test_values_are_required_unless_count():
    mesh = pm.key_mesh([torch.device("cpu")] * 2)
    keys = np.arange(10, dtype=np.uint32)
    with pytest.raises(ValueError, match="values required"):
        pp.hash_aggregate_distributed(keys, op="sum", mesh=mesh)
    with pytest.raises(ValueError, match="1-D"):
        pp.hash_aggregate_distributed(keys, keys[:5], op="sum", mesh=mesh)
    with pytest.raises(ValueError, match="op must be one of"):
        pp.build_hash_aggregate(mesh, 8, op="mean")


def test_inverse_hash_round_trip():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 32, 1 << 14, dtype=np.uint64).astype(np.uint32)
    keys[:4] = [0, 1, 0xFFFFFFFF, PAD_HASH_KEY]
    h = pt.hash_u32(torch.from_numpy(keys))
    assert h.view(torch.int32)[3].item() == -1  # PAD_HASH_KEY hashes to 0xFFFFFFFF
    np.testing.assert_array_equal(pt._unhash_u32(h).numpy(), keys)
    words = torch.from_numpy(keys)  # the inverse is a bijection too
    np.testing.assert_array_equal(pt.hash_u32(pt._unhash_u32(words)).numpy(), keys)


def test_hash_aggregate_pipeline_matches_jax():
    fn, args = HashAggregatePipeline(n_local=N_LOCAL, op="sum",
                                     mesh=pm.key_mesh([torch.device("cpu")] * 8)).build()
    jfn, jargs = JaxHashAggregatePipeline(n_local=N_LOCAL, op="sum", mesh=_jax_mesh(8)).build()
    for got, want in zip(args, jargs):
        np.testing.assert_array_equal(pm.unshard(got).numpy(), np.asarray(want))
    _same_ranks(8, fn(*args), jfn(*jargs))


def test_cli_selftest_passes_on_cpu(capsys):
    assert port_cli(["selftest", "--device", "cpu", "--n", "4096"]) == 0
    lines = capsys.readouterr().out.rstrip().splitlines()
    checks = [line for line in lines if line.startswith("  ")]
    assert len(checks) == 14 and all(line.startswith("  PASS  ") for line in checks)
    assert lines[-1] == "selftest: OK"
