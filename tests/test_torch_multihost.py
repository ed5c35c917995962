"""The port's multi-process helpers (parallel/multihost.py) and the
process-group form of its key mesh (parallel/mesh.py) in one process: the
counterparts of tests/test_multihost.py, the export of every public name of
the JAX package's ``parallel``, ``host_chip_mesh``, and the mesh paths over a
gloo group of one process holding 8 CPU ranks (a file store in
``tmp_path``), which must give the single-controller ``[cpu] * 8`` mesh's
bytes, rank by rank: the whole sorts, and the raw rounds of the peer-memory
exchanges (B6, B7), whose receive buffers (``parallel/peer_memory.py``, a
shared-memory file a rank on the CPU) must hold every key at its global
place.  tests/test_torch_multiprocess.py takes the same mesh across real
processes."""

import ast
import os
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import gpu_radix_sort_tpu_torch as port
import gpu_radix_sort_tpu_torch.parallel as port_parallel
from gpu_radix_sort_tpu.parallel import host_chip_mesh as jax_host_chip_mesh
from gpu_radix_sort_tpu.utils.keygen import Pcg32
from gpu_radix_sort_tpu_torch.parallel import distributed as pd
from gpu_radix_sort_tpu_torch.kernels import build
from gpu_radix_sort_tpu_torch.ops.radix_sort import sort_by_digits
from gpu_radix_sort_tpu_torch.parallel import mesh as pm
from gpu_radix_sort_tpu_torch.parallel import peer_memory
from gpu_radix_sort_tpu_torch.parallel import pipeline as pp
from gpu_radix_sort_tpu_torch.parallel import rdma_exchange as rx
from gpu_radix_sort_tpu_torch.parallel import rdma_overlap as ov
from gpu_radix_sort_tpu_torch.parallel import sample_sort as ss
from gpu_radix_sort_tpu_torch.parallel.multihost import (
    initialize_distributed,
    pod_key_mesh,
    process_shard_bounds,
)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
P = 8
RUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def group_mesh(tmp_path):
    """A gloo group of this one process, through a file store, and the
    process-group mesh of its 8 CPU ranks; the group is destroyed after."""
    assert initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0, backend="gloo") is False
    try:
        yield pod_key_mesh([CPU] * P)
    finally:
        dist.destroy_process_group()


def _jax_public_names() -> set[str]:
    tree = ast.parse((REPO / "gpu_radix_sort_tpu" / "parallel" / "__init__.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_every_public_name_of_the_jax_parallel_package_is_ported():
    import gpu_radix_sort_tpu.parallel as jax_parallel

    names = _jax_public_names()
    assert {"host_chip_mesh", "key_mesh", "mesh", "exchange", "build_sample_sort"} <= names
    assert names <= set(dir(jax_parallel))
    assert not {n for n in names if not hasattr(port_parallel, n)}


def test_initialize_is_a_no_op_when_nothing_names_a_run(monkeypatch):
    for name in RUN_ENV:
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    assert not dist.is_initialized()


def test_initialize_over_nccl_without_cuda_raises_before_any_bring_up(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gloo"):
        initialize_distributed("localhost:29500", 1, 0)
    assert not dist.is_initialized()


def test_initialize_reads_torchrun_variables_and_is_idempotent(tmp_path, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    # a world of one through the file store: nothing listens on the port
    assert initialize_distributed(f"file://{tmp_path / 'store'}", backend="gloo") is False
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert initialize_distributed(backend="gloo") is False  # already up: nothing new
    finally:
        dist.destroy_process_group()


def test_pod_key_mesh_without_a_group_is_the_single_controller_mesh():
    assert pod_key_mesh([CPU] * P) == pm.key_mesh([CPU] * P)


def test_pod_key_mesh_orders_host_major(group_mesh):
    assert (group_mesh.size, group_mesh.first, group_mesh.processes) == (P, 0, 1)
    assert group_mesh.devices == (CPU,) * P
    # process 1 of 2 holding 4 ranks: global ranks 4-7, rows in that order
    second = pm.KeyMesh((CPU,) * 4, group=object(), first=4, processes=2)
    x = torch.arange(16)
    assert [s.tolist() for s in pm.shard(x, second)] == [[8, 9], [10, 11], [12, 13], [14, 15]]


@pytest.mark.parametrize("grouped", [False, True])
def test_process_shard_bounds_cover_everything_in_one_process(grouped, tmp_path):
    if not grouped:
        assert process_shard_bounds(1000, pod_key_mesh([CPU] * P)) == (0, 1000)
        return
    initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0, backend="gloo")
    try:
        assert process_shard_bounds(1000, pod_key_mesh([CPU] * P)) == (0, 1000)
    finally:
        dist.destroy_process_group()


def test_process_shard_bounds_tail_host_clamped():
    """A process whose nominal range starts past n_global owns nothing: the
    range stays within [0, n_global] with lo <= hi (JAX's cases)."""
    tail = pm.KeyMesh((CPU,) * 8, group=object(), first=8, processes=2)
    assert process_shard_bounds(3, tail) == (3, 3)  # per_chip=1; nominal [8, 16)
    assert process_shard_bounds(12, tail) == (8, 12)  # nominal [8, 16) -> [8, 12)


def test_distributed_sort_on_pod_mesh():
    keys = Pcg32().fill(5000)
    out = port.sort_distributed(torch.from_numpy(keys), mesh=pod_key_mesh([CPU] * P), width=16)
    np.testing.assert_array_equal(out.numpy(), np.sort(keys))


@pytest.mark.parametrize("ndev,hosts", [(8, 1), (8, 2), (8, 4), (6, 3)])
def test_host_chip_mesh_matches_jax(ndev, hosts):
    jmesh = jax_host_chip_mesh(jax.devices("cpu")[:ndev], hosts)
    mesh = port_parallel.host_chip_mesh([CPU] * ndev, hosts)
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.devices == ((CPU,) * (ndev // hosts),) * hosts


def test_host_chip_mesh_raises_where_jax_does():
    with pytest.raises(ValueError, match="not divisible"):
        jax_host_chip_mesh(jax.devices("cpu")[:6], 4)
    with pytest.raises(ValueError, match="not divisible"):
        port_parallel.host_chip_mesh([CPU] * 6, 4)
    assert port_parallel.host_chip_mesh([CPU] * 6).shape == {"host": 1, "chip": 6}


def test_group_mesh_holds_its_ranks_on_one_device(group_mesh):
    with pytest.raises(ValueError, match="single-controller"):
        pm.key_mesh([torch.device("cuda", 0), torch.device("cuda", 1)], group=dist.group.WORLD)


def _inputs(n_local: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    n = n_local * P
    keys = Pcg32(state=seed + 1).fill(n)
    return {
        "keys": keys,
        "hi": rng.integers(0, 4, n, dtype=np.uint64).astype(np.uint32),
        "vals": rng.integers(0, 1 << 32, (n, 3), dtype=np.uint64).astype(np.uint32),
        "agg": (np.arange(n, dtype=np.uint64) * 2654435761 % 301).astype(np.uint32),
        "fvals": (rng.integers(-8, 8, n) * 0.25).astype(np.float32),
    }


def _run(path: str, mesh, n_local: int) -> tuple[list, list]:
    """(valid counts, [each rank's valid prefix of each output]) of one
    path's build function on ``mesh``."""
    data = {k: pm.shard(torch.from_numpy(v), mesh) for k, v in _inputs(n_local).items()}
    kind, what = path.split(maxsplit=1)
    full = [torch.full((1,), n_local)] * len(mesh.devices)
    if kind == "lsd":
        out, overflow = pd.build_distributed_sort(
            mesh, n_local, width=8, exchange=what, capacity_factor=1.5)(data["keys"])
        outs, counts = [out], full
    elif kind == "lsd16":
        out, overflow = pd.build_distributed_sort(
            mesh, n_local, width=16, exchange=what, fuse_rounds=False)(data["keys"])
        outs, counts = [out], full
    elif path in ("sample sort", "sample merge"):
        fn, _ = ss.build_sample_sort(mesh, n_local, reassembly=what)
        out, counts, overflow = fn(data["keys"])
        outs = [out]
    elif path == "sample kv":
        *outs, counts, overflow = ss.build_sample_sort_kv(mesh, n_local, 3)[0](
            data["keys"], data["vals"])
    elif path == "sample 64":
        *outs, counts, overflow = ss.build_sample_sort_64(mesh, n_local)[0](
            data["hi"], data["keys"])
    elif path == "sample kv64":
        *outs, counts, overflow = ss.build_sample_sort_kv64(mesh, n_local, 3)[0](
            data["hi"], data["keys"], data["vals"])
    else:
        values = data["fvals"] if what != "count" else data["agg"]
        fn, _ = pp.build_hash_aggregate(mesh, n_local, op=what)
        valid = [k != 0 for k in data["agg"]]  # a few rows dropped
        *outs, counts, overflow = fn(data["agg"], values, valid)
    assert int(overflow) == 0
    counts = [int(c) for c in counts]
    return counts, [[o[r][:c] for r, c in enumerate(counts)] for o in outs]


PATHS = [
    "lsd alltoall", "lsd overflow", "lsd gather", "lsd16 alltoall",
    "sample sort", "sample merge", "sample kv", "sample 64", "sample kv64",
    "aggregate count", "aggregate sum", "aggregate max",
]


@pytest.mark.parametrize("path", PATHS)
def test_group_of_one_process_matches_the_single_controller(group_mesh, path):
    n_local = 1111
    got_counts, got = _run(path, group_mesh, n_local)
    want_counts, want = _run(path, pm.key_mesh([CPU] * P), n_local)
    assert got_counts == want_counts
    for g_out, w_out in zip(got, want):
        for g, w in zip(g_out, w_out):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    assert pm.staged_bytes == 0  # a CPU mesh stages nothing


@pytest.fixture
def shm_root(tmp_path, monkeypatch):
    """The shared-memory plane's directory, empty, for this test alone."""
    root = tmp_path / "shm"
    root.mkdir()
    monkeypatch.setattr(peer_memory, "SHM_ROOT", str(root))
    return root


@pytest.mark.parametrize("exchange", ["rdma", "rdma_overlap"])
def test_group_mesh_rejects_the_peer_memory_exchanges(group_mesh, shm_root, exchange):
    """The two exchanges that store into the peers' receive buffers, which
    raised on a process-group mesh until they were ported, now build there
    and give the single controller's bytes rank by rank, twice from one
    build (its receive buffers are reused); the shared-memory files are
    gone once the sort is built."""
    n_local = 2048
    keys = torch.from_numpy(Pcg32(state=5).fill(n_local * P))
    fn = pd.build_distributed_sort(group_mesh, n_local, exchange=exchange, overlap_tile=1024)
    assert list(shm_root.iterdir()) == []
    want, _ = pd.build_distributed_sort(pm.key_mesh([CPU] * P), n_local, exchange=exchange,
                                        overlap_tile=1024)(pm.shard(keys, group_mesh))
    for _ in range(2):
        got, overflow = fn(pm.shard(keys, group_mesh))
        assert int(overflow) == 0
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.sort(keys.numpy()))
    with pytest.raises(ValueError, match="shards"):
        fn(pm.shard(keys, group_mesh)[1:])
    assert list(shm_root.iterdir()) == []


def _skewed(n: int, seed: int = 3) -> torch.Tensor:
    """Keys whose digit (bits 8-15) follows Zipf(1.3): the segments run from
    one rank's whole shard to empty."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.zipf(1.3, n) % (1 << 16)).astype(np.uint32) << np.uint32(8))


@pytest.mark.parametrize("offsets", [None, [1, 2, 3, 0, 1, 2, 3, 1]], ids=["aligned", "shifted"])
@pytest.mark.parametrize("kernel", ["B6", "B7"])
def test_group_mesh_raw_rounds_match_the_single_controller(group_mesh, shm_root, kernel,
                                                           offsets):
    """One exchange round before its reassembly: the receive buffers of the
    process-group round (local rank i is global rank ``first + i``; the
    buffers at the given word offsets) equal the single controller's, key
    for key, so every store landed at its global place."""
    n_local = 2048 if kernel == "B7" else 1111
    x = _skewed(n_local * P)
    peers = peer_memory.PeerBuffers(group_mesh, n_local, offsets=offsets)
    if kernel == "B6":
        sorted_ = [sort_by_digits(s, 8, 8) for s in pm.shard(x, group_mesh)]
        _, got, _ = rx.exchange_round_rdma_raw(sorted_, 8, 8, group_mesh, peers)
        _, want, _ = rx.exchange_round_rdma_raw([s.clone() for s in sorted_], 8, 8)
    else:
        shards = pm.shard(x, group_mesh)
        got = ov.exchange_round_rdma_overlapped_raw(shards, 8, 8, tile=1024, mesh=group_mesh,
                                                    peers=peers)
        want = ov.exchange_round_rdma_overlapped_raw(shards, 8, 8, tile=1024)
    assert got is peers.local and [g.numel() for g in got] == [n_local] * P
    assert [g.data_ptr() % 16 for g in got] == [4 * o for o in offsets or [0] * P]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert list(shm_root.iterdir()) == []


@pytest.mark.parametrize("where", ["here", "there"])
def test_a_failed_mapping_raises_everywhere_and_leaves_nothing_behind(
        group_mesh, shm_root, tmp_path, monkeypatch, where):
    """A process that cannot map a peer's buffer (here: a second process's
    files lie on no host this one sees; there: that process reports such a
    failure) makes every process raise after the second exchange, and this
    process's files are gone either way."""
    two = pm.KeyMesh((CPU,) * 4, group=group_mesh.group, first=0, processes=2)
    peer = tmp_path / "peer"
    peer.mkdir()
    if where == "there":  # the peer's buffers exist, and it fails to map this one's
        for g in range(4, 8):
            torch.from_file(str(peer / f"rank{g}"), shared=True, size=1024, dtype=torch.int32)
    exchanged = []

    def gather(side, value):
        exchanged.append(value)
        if len(exchanged) == 1:  # the handles
            assert [os.path.basename(h) for h, _ in value] == ["rank0", "rank1", "rank2", "rank3"]
            return [value, [(str(peer / f"rank{g}"), 0) for g in range(4, 8)]]
        return [value, "process 1: no receive buffer" if where == "there" else None]

    monkeypatch.setattr(peer_memory, "gather_objects", gather)
    with pytest.raises(RuntimeError, match="could not map"):
        peer_memory.PeerBuffers(two, 1024)
    assert (exchanged[1] is None) == (where == "there")
    assert list(shm_root.iterdir()) == []


@pytest.mark.parametrize("entry", ["grs_ipc_alloc", "grs_ipc_open"])
def test_an_ipc_failure_raises(monkeypatch, entry):
    """A CUDA status other than 0 from the IPC entry points raises (here
    from a stand-in for the kernel library: this host has no card)."""
    class Lib:
        def __getattr__(self, name):
            return lambda *args: 201 if name == entry else 0

        @staticmethod
        def grs_error_string(status):
            return b"invalid device context"

    monkeypatch.setattr(build, "load", lambda: Lib())
    cuda0 = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="CUDA error 201"):
        if entry == "grs_ipc_alloc":
            peer_memory._alloc(cuda0, None, "rank0", 16, True)
        else:
            peer_memory._open(cuda0, bytes(64), 16)


def test_peer_buffers_serve_a_process_group_mesh_only(group_mesh, shm_root):
    with pytest.raises(ValueError, match="process-group"):
        peer_memory.PeerBuffers(pm.key_mesh([CPU] * P), 16)
    shards = pm.shard(_skewed(16 * P), group_mesh)
    with pytest.raises(ValueError, match="pass peers"):
        rx.exchange_round_rdma_raw(shards, 8, 8, group_mesh)
    with pytest.raises(ValueError, match="hold 32 keys"):
        rx.exchange_round_rdma_raw(shards, 8, 8, group_mesh,
                                   peer_memory.PeerBuffers(group_mesh, 32))


HOST_ENTRIES = {
    "sort_distributed": ("build_distributed_sort", lambda k, v, m: port.sort_distributed(k, mesh=m)),
    "sort_distributed_sample": ("build_sample_sort",
                                lambda k, v, m: port.sort_distributed_sample(k, mesh=m)),
    "sort_key_value_distributed": ("build_sample_sort_kv",
                                   lambda k, v, m: port.sort_key_value_distributed(k, v, mesh=m)),
    "sort_distributed_64": ("build_sample_sort_64",
                            lambda k, v, m: port.sort_distributed_64(k.to(torch.uint64), mesh=m)),
    "sort_key_value_distributed_64": ("build_sample_sort_kv64",
                                      lambda k, v, m: port.sort_key_value_distributed_64(
                                          k.to(torch.uint64), v, mesh=m)),
    "hash_aggregate_distributed": ("build_hash_aggregate",
                                   lambda k, v, m: port.hash_aggregate_distributed(
                                       k, op="count", mesh=m)),
}


@pytest.mark.parametrize("entry", sorted(HOST_ENTRIES))
def test_host_entries_raise_on_a_group_mesh(group_mesh, entry):
    build, call = HOST_ENTRIES[entry]
    keys = torch.from_numpy(Pcg32().fill(100))
    vals = torch.zeros((100, 1), dtype=torch.uint32)
    with pytest.raises(ValueError, match=build):
        call(keys, vals, group_mesh)


def test_mesh_counts_one_collective_a_call_whatever_its_ranks(group_mesh, monkeypatch):
    """Each collective of the mesh is one torch.distributed call for all the
    process's ranks (the podscale guard's unit)."""
    calls = []
    for name in ("all_gather", "all_to_all_single", "all_reduce"):
        f = getattr(dist, name)
        monkeypatch.setattr(dist, name, lambda *a, _f=f, _n=name, **k: (calls.append(_n), _f(*a, **k))[1])
    x = [torch.full((3,), r, dtype=torch.int64) for r in range(P)]
    gathered = pm.all_gather(x, group_mesh)
    assert all(torch.equal(g, torch.stack(x)) for g in gathered)
    blocks = [torch.arange(P * 2, dtype=torch.int32).view(P, 2) + 100 * r for r in range(P)]
    got = pm.all_to_all(blocks, group_mesh)
    want = pm.all_to_all(blocks)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(pm.psum([torch.tensor(r) for r in range(P)], group_mesh)) == sum(range(P))
    assert calls == ["all_gather", "all_to_all_single", "all_reduce"]


def test_staging_through_host_memory_keeps_every_byte(group_mesh, monkeypatch):
    """The route of a gloo group on a card (each collective copied to host
    memory and back, its bytes counted), taken here on CPU tensors: the
    same bytes as the single-controller mesh, and the staged bytes counted."""
    monkeypatch.setattr(pm, "_staged", lambda mesh: True)
    monkeypatch.setattr(pm, "staged_bytes", 0)
    got_counts, got = _run("sample kv", group_mesh, 1111)
    staged = pm.staged_bytes
    monkeypatch.undo()
    want_counts, want = _run("sample kv", pm.key_mesh([CPU] * P), 1111)
    assert got_counts == want_counts
    for g_out, w_out in zip(got, want):
        assert all(torch.equal(g, w) for g, w in zip(g_out, w_out))
    cap = ss.default_pair_capacity(1111, P, 1.5)
    windows = P * P * cap * 4 * (1 + 3)  # keys and three payload lanes, one way
    assert staged > 2 * windows


def test_the_gloo_side_group_of_an_nccl_group_is_made_once(group_mesh, monkeypatch):
    """The one-time exchanges of an NCCL group (the mesh's checks, every
    peer-memory build) share one gloo side group, made at the first: a
    second group over the same ranks takes the first one's name, and across
    processes its rendezvous reads the first one's stale keys and hangs."""
    made = []
    real_new_group = dist.new_group
    monkeypatch.setattr(pm, "_SIDE_GROUPS", {}, raising=False)
    monkeypatch.setattr(pm.dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(pm.dist, "new_group",
                        lambda *a, **k: made.append(k) or real_new_group(*a, **k))
    for value in ("uuid", "handles", "outcome"):
        assert pm._exchange_once(group_mesh.group, value) == [value]
    assert len(made) == 1 and made[0]["backend"] == "gloo"
    assert pm.side_group(group_mesh.group) is pm.side_group(group_mesh.group)
    assert len(made) == 1


@pytest.mark.parametrize("seen,match", [
    ([(1, "GPU-a"), (1, "GPU-a")], "name the same card"),  # two NCCL processes on one card
    ([(1, "GPU-a"), (2, "GPU-b")], "same number of ranks"),
])
def test_group_mesh_checks_every_process_before_the_first_collective(
        group_mesh, monkeypatch, seen, match):
    """What the processes report when the mesh is built (each one's ranks
    and card, gathered over gloo before NCCL's first call) must agree."""
    monkeypatch.setattr(pm.dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(pm, "_card_uuid", lambda device: "GPU-a")
    monkeypatch.setattr(pm, "_exchange_once", lambda group, value: seen)
    with pytest.raises(ValueError, match=match):
        pm.key_mesh([torch.device("cuda", 0)], group=dist.group.WORLD)
