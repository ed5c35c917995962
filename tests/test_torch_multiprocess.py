"""The port's process-group key mesh across real processes
(``parallel/multihost.py``, the process-group form of ``parallel/mesh.py``).

W child processes (``tests/torch_mp_child.py``) join one gloo group through a
file store in ``tmp_path`` (no TCP port, so several test workers may run this
at once), each holding L CPU ranks, for (W, L) in {(2, 4), (3, 1)}.  Each
child runs the mesh LSD sort, the sample sort and the hash aggregate through
their ``build_*`` functions and writes its ranks' valid outputs.  Per global
rank, byte for byte, they must equal:

  * JAX's build functions on its single-process CPU mesh of the first
    P = W * L devices, for the LSD sort (``alltoall``, w8, capacity 1.5),
    PSRS of 32-bit keys and the hash aggregate ``sum`` over
    tests/mp_child.py's 977 keys (XLA sorts on the JAX side, never a
    Pallas kernel);
  * the port's single-controller ``[cpu] * P`` mesh, for the LSD
    ``overflow``, ``gather``, ``rdma`` and ``rdma_overlap`` exchanges, PSRS
    "merge", the key-value and 64-bit sample sorts and the ``count``
    aggregate.

The two peer-memory exchanges store into the other processes' receive
buffers (shared memory on the CPU, CUDA IPC on a card); their ranks joined
in rank order must also equal JAX's ``sort_distributed`` of the same keys
through its ``gather`` exchange on XLA sorts (never JAX's ``rdma`` paths,
Pallas interpret-mode kernels), and np.sort, and no process may leave a
shared-memory file behind.

The children also check the error paths (the host entries raise
ValueError on a process-group mesh) and count the ``torch.distributed``
calls of each path's call (the build's one-time exchanges aside): the
counterpart of JAX's ``bench/podscale.py`` guard, which holds that the
sharded programs do not grow with P.  The port compiles nothing, so what
could grow is the number of collectives; it must be the same at (2, 4) and
(3, 1), one call a collective whatever the ranks a process holds.
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from gpu_radix_sort_tpu.parallel import distributed as jdist
from gpu_radix_sort_tpu.parallel import key_mesh as jax_key_mesh
from gpu_radix_sort_tpu.parallel import pipeline as jp
from gpu_radix_sort_tpu.parallel import sample_sort as js
from gpu_radix_sort_tpu_torch.parallel import distributed as pd
from gpu_radix_sort_tpu_torch.parallel import pipeline as pp
from gpu_radix_sort_tpu_torch.parallel import sample_sort as ss
from gpu_radix_sort_tpu_torch.parallel.mesh import key_mesh, shard

REPO = Path(__file__).resolve().parent.parent
CHILD = REPO / "tests" / "torch_mp_child.py"
CASES = [(2, 4), (3, 1)]
CHILD_TIMEOUT = 120  # seconds; a child takes ~4 s
_spec = importlib.util.spec_from_file_location("torch_mp_child", CHILD)
child = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(child)

# torch.distributed calls of one call of each path's function, in every
# process whatever its (W, L): LSD w8 = 4 rounds of (counts all_gather +
# all_to_all; overflow two all_to_alls; gather one all_gather; rdma and
# rdma_overlap the drain's barrier) + the overflow psum; PSRS = samples,
# keys (and payload), counts, overflow; hash aggregate = samples, overflow,
# keys, aggregates, counts.
COLLECTIVE_CALLS = {
    "lsd alltoall": 9, "lsd overflow": 13, "lsd gather": 5, "lsd rdma": 9,
    "lsd rdma_overlap": 9,
    "sample sort": 4, "sample merge": 4, "sample kv": 5, "sample 64": 4,
    "aggregate sum": 5, "aggregate count": 5,
}
SINGLE_CONTROLLER_PATHS = [
    "lsd overflow", "lsd gather", "lsd rdma", "lsd rdma_overlap", "sample merge", "sample kv",
    "sample 64", "aggregate count",
]
ERRORS = [
    "sort_distributed", "sort_distributed_sample", "sort_key_value_distributed",
    "sort_distributed_64", "sort_key_value_distributed_64", "hash_aggregate_distributed",
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(W, L)``: the children's outputs of one (W, L), spawned once a
    module: (arrays by "path|global rank|what", the processes' reports)."""
    done = {}

    def get(W: int, L: int):
        if (W, L) not in done:
            done[(W, L)] = _spawn(W, L, tmp_path_factory.mktemp(f"mp{W}x{L}"))
        return done[(W, L)]

    return get


def _spawn(W: int, L: int, out: Path):
    store = out / "store"
    procs = [
        subprocess.Popen(
            [sys.executable, str(CHILD), str(pid), str(W), str(L), str(store), str(out)],
            cwd=REPO, env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(W)
    ]
    try:
        # drain every child at once: they progress together through the collectives
        with ThreadPoolExecutor(W) as pool:
            drained = list(pool.map(lambda p: p.communicate(timeout=CHILD_TIMEOUT), procs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, (stdout, stderr)) in enumerate(zip(procs, drained)):
        assert p.returncode == 0 and f"CHILD_OK {pid}" in stdout, (
            f"child {pid} of {W} exited {p.returncode}\n{stdout}\n{stderr[-4000:]}")
    arrays, reports = {}, []
    for pid in range(W):
        with np.load(out / f"{pid}.npz") as z:
            arrays.update({k: z[k] for k in z.files})
        reports.append(json.loads((out / f"{pid}.json").read_text()))
    return arrays, reports


def _rank(arrays: dict, path: str, g: int) -> tuple[int, dict]:
    prefix = f"{path}|{g}|"
    count = int(arrays[prefix + "count"])
    return count, {k[len(prefix):]: v for k, v in arrays.items()
                   if k.startswith(prefix) and not k.endswith("|count")}


def _same(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@functools.lru_cache(maxsize=None)
def _jax_mesh(P: int):
    return jax_key_mesh(jax.devices("cpu")[:P])


def _jax_put(a: np.ndarray, P: int):
    return jax.device_put(a, NamedSharding(_jax_mesh(P), PartitionSpec("x")))


def _check_against(arrays, path, P, counts, buffers, overflow) -> None:
    """Every rank's count and valid prefix of each named buffer (the P
    ranks' buffers joined on axis 0) against the children's."""
    assert int(overflow) == 0
    counts = np.asarray(counts).reshape(-1)
    for g in range(P):
        count, got = _rank(arrays, path, g)
        assert count == counts[g], (path, g)
        assert set(got) == set(buffers)
        for what, want in buffers.items():
            _same(got[what], np.asarray(want).reshape(P, -1, *np.shape(want)[1:])[g, :count])


@pytest.mark.parametrize("W,L", CASES)
def test_lsd_alltoall_across_processes_matches_jax(runs, W, L):
    arrays, _ = runs(W, L)
    P = W * L
    keys = child.inputs(P)["keys"]
    fn = jdist.build_distributed_sort(_jax_mesh(P), child.N_LOCAL, width=8,
                                      exchange="alltoall", capacity_factor=1.5,
                                      strategy="xla")
    out, overflow = fn(_jax_put(keys, P))
    _check_against(arrays, "lsd alltoall", P, np.full(P, child.N_LOCAL),
                   {"keys": np.asarray(out)}, overflow)
    assert np.array_equal(np.asarray(out), np.sort(keys))


@pytest.mark.parametrize("W,L", CASES)
def test_sample_sort_across_processes_matches_jax(runs, W, L):
    arrays, _ = runs(W, L)
    P = W * L
    fn, _ = js.build_sample_sort(_jax_mesh(P), child.N_LOCAL, capacity_factor=1.5)
    out, counts, overflow = fn(_jax_put(child.inputs(P)["keys"], P))
    _check_against(arrays, "sample sort", P, counts, {"keys": np.asarray(out)}, overflow)


@pytest.mark.parametrize("W,L", CASES)
def test_hash_aggregate_across_processes_matches_jax(runs, W, L):
    arrays, _ = runs(W, L)
    P = W * L
    data = child.inputs(P)
    fn, _ = jp.build_hash_aggregate(_jax_mesh(P), child.AGG_LOCAL, op="sum")
    gk, ga, ng, overflow = fn(_jax_put(data["agg_keys"], P), _jax_put(data["agg_vals"], P),
                              _jax_put(np.ones(data["agg_keys"].size, bool), P))
    _check_against(arrays, "aggregate sum", P, ng,
                   {"keys": np.asarray(gk), "aggs": np.asarray(ga)}, overflow)
    assert np.asarray(ng).sum() == 977


def _single_controller(path: str, P: int):
    """(counts, buffers by name, overflow) of ``path`` on the port's
    single-controller ``[cpu] * P`` mesh."""
    mesh = key_mesh([torch.device("cpu")] * P)
    data = {k: shard(torch.from_numpy(v), mesh) for k, v in child.inputs(P).items()}
    joined = lambda ts: torch.cat(list(ts)).numpy()  # noqa: E731  (JAX's global layout)
    kind, what = path.split()
    if kind == "lsd":
        fn = pd.build_distributed_sort(mesh, child.N_LOCAL, width=8, exchange=what,
                                       capacity_factor=1.5, overlap_tile=child.OVERLAP_TILE)
        out, overflow = fn(data["keys"])
        return np.full(P, child.N_LOCAL), {"keys": joined(out)}, overflow
    if path == "sample merge":
        fn, _ = ss.build_sample_sort(mesh, child.N_LOCAL, capacity_factor=1.5, reassembly="merge")
        out, counts, overflow = fn(data["keys"])
        return joined(counts), {"keys": joined(out)}, overflow
    if path == "sample kv":
        fn, _ = ss.build_sample_sort_kv(mesh, child.N_LOCAL, child.LANES, capacity_factor=1.5)
        k, v, counts, overflow = fn(data["keys"], data["vals"])
        return joined(counts), {"keys": joined(k), "vals": joined(v)}, overflow
    if path == "sample 64":
        fn, _ = ss.build_sample_sort_64(mesh, child.N_LOCAL, capacity_factor=1.5)
        hi, lo, counts, overflow = fn(data["hi"], data["keys"])
        return joined(counts), {"hi": joined(hi), "lo": joined(lo)}, overflow
    fn, _ = pp.build_hash_aggregate(mesh, child.AGG_LOCAL, op="count")
    valid = [torch.ones(child.AGG_LOCAL, dtype=torch.bool)] * P
    gk, ga, ng, overflow = fn(data["agg_keys"], data["agg_vals"], valid)
    return joined(ng), {"keys": joined(gk), "aggs": joined(ga)}, overflow


@pytest.mark.parametrize("path", SINGLE_CONTROLLER_PATHS)
@pytest.mark.parametrize("W,L", CASES)
def test_paths_across_processes_match_the_single_controller(runs, W, L, path):
    arrays, _ = runs(W, L)
    _check_against(arrays, path, W * L, *_single_controller(path, W * L))


@pytest.mark.parametrize("exchange", ["rdma", "rdma_overlap"])
@pytest.mark.parametrize("W,L", CASES)
def test_peer_memory_exchanges_across_processes_match_jax_gather(runs, W, L, exchange):
    """The ranks joined in rank order against JAX's exact gather exchange
    (XLA sorts) and np.sort: the per-rank split may differ between
    exchanges, the global bytes may not."""
    arrays, _ = runs(W, L)
    P = W * L
    keys = child.inputs(P)["keys"]
    joined = np.concatenate([_rank(arrays, f"lsd {exchange}", g)[1]["keys"] for g in range(P)])
    want = jdist.sort_distributed(keys, mesh=_jax_mesh(P), width=8, exchange="gather",
                                  strategy="xla")
    _same(joined, np.asarray(want))
    _same(joined, np.sort(keys))


@pytest.mark.parametrize("W,L", CASES)
def test_peer_memory_leaves_no_shared_memory_behind(runs, W, L):
    _, reports = runs(W, L)
    assert [r["shm_left"] for r in reports] == [[]] * W


@pytest.mark.parametrize("W,L", CASES)
def test_process_group_mesh_rejects_peer_memory_and_host_entries(runs, W, L):
    """Every host entry raises ValueError on a process-group mesh (the
    peer-memory exchanges, which raised here before they were ported, now
    run: see the tests above)."""
    _, reports = runs(W, L)
    for report in reports:
        assert report["errors"] == ERRORS


@pytest.mark.parametrize("W,L", CASES)
def test_collective_calls_do_not_grow_with_the_ranks(runs, W, L):
    """The podscale guard: each path makes the same torch.distributed calls
    in every process at (2, 4) and at (3, 1), and none overflowed."""
    _, reports = runs(W, L)
    for report in reports:
        assert report["calls"] == COLLECTIVE_CALLS
        assert set(report["overflow"].values()) == {0}
