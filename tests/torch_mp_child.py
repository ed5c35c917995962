"""Child program of tests/test_torch_multiprocess.py: one process of the
port's process-group key mesh.

Run in W OS processes, each holding L CPU ranks of one key mesh of P = W * L
ranks, joined by ``torch.distributed`` over gloo through a file store (no
TCP port).  Each process runs the mesh LSD sort (among others through the
``rdma`` and ``rdma_overlap`` exchanges, whose kernels' plain versions store
into the other processes' receive buffers through shared memory), the
sample sort (PSRS) and the hash aggregate through their ``build_*``
functions on its own shards of inputs that every process makes alike from a
seed, counts the ``torch.distributed`` calls of each path's call (not of
its build), checks the error paths and that the shared-memory plane left
nothing behind, and writes its ranks' outputs to
``<out_dir>/<process_id>.npz`` and its counts to
``<out_dir>/<process_id>.json`` for the parent to compare.

Usage: python tests/torch_mp_child.py <process_id> <num_processes> <ranks> <store> <out_dir>

Prints CHILD_OK <process_id> on success; any failure exits non-zero.  Not
named test_* so pytest does not collect it.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

N_LOCAL = 2048  # keys a rank, as tests/mp_child.py
AGG_LOCAL = 1024  # hash-aggregate rows a rank, as tests/mp_child.py
LANES = 2  # payload lanes of the key-value sample sort
OVERLAP_TILE = 1024  # rdma_overlap's group tile: two groups a rank

# every torch.distributed collective the port could call
COLLECTIVES = (
    "all_gather", "all_gather_into_tensor", "all_gather_object", "all_reduce",
    "all_to_all", "all_to_all_single", "barrier", "broadcast", "broadcast_object_list",
    "gather", "irecv", "isend", "recv", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "scatter", "send",
)


def inputs(P: int) -> dict:
    """The global inputs, alike in every process (and in the parent)."""
    from gpu_radix_sort_tpu_torch.utils.keygen import Pcg32

    n = N_LOCAL * P
    rng = np.random.default_rng(P)
    rows = AGG_LOCAL * P
    return {
        "keys": Pcg32().fill(n),
        "vals": rng.integers(0, 1 << 32, (n, LANES), dtype=np.uint64).astype(np.uint32),
        "hi": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        "agg_keys": (np.arange(rows, dtype=np.uint64) * 2654435761 % 977).astype(np.uint32),
        "agg_vals": np.ones(rows, np.uint32),
    }


def count_collectives() -> list:
    """Wraps every collective of ``torch.distributed`` so that it counts its
    calls in the returned one-element list."""
    calls = [0]
    for name in COLLECTIVES:
        f = getattr(dist, name, None)
        if f is None:
            continue

        def counted(*args, _f=f, **kwargs):
            calls[0] += 1
            return _f(*args, **kwargs)

        setattr(dist, name, counted)
    return calls


def main() -> None:
    pid, W, L = (int(a) for a in sys.argv[1:4])
    store, out_dir = sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)

    from gpu_radix_sort_tpu_torch.parallel import distributed as pd
    from gpu_radix_sort_tpu_torch.parallel import peer_memory
    from gpu_radix_sort_tpu_torch.parallel import pipeline as pp
    from gpu_radix_sort_tpu_torch.parallel import sample_sort as ss
    from gpu_radix_sort_tpu_torch.parallel.mesh import shard
    from gpu_radix_sort_tpu_torch.parallel.multihost import (
        initialize_distributed, pod_key_mesh, process_shard_bounds,
    )

    peer_memory.SHM_ROOT = os.path.join(out_dir, f"shm{pid}")
    os.makedirs(peer_memory.SHM_ROOT)
    active = initialize_distributed(f"file://{store}", W, pid, backend="gloo")
    assert active == (W > 1), active
    mesh = pod_key_mesh([torch.device("cpu")] * L)
    P = W * L
    assert (mesh.size, mesh.first, mesh.processes) == (P, pid * L, W), mesh
    per = -(-1000 // P)
    assert process_shard_bounds(1000, mesh) == (
        min(pid * L * per, 1000), min((pid + 1) * L * per, 1000))

    data = {k: torch.from_numpy(v) for k, v in inputs(P).items()}
    local = {k: shard(v, mesh) for k, v in data.items()}
    ones = [torch.ones(AGG_LOCAL, dtype=torch.bool)] * L

    # each builds its path's function (every process together) and returns
    # the call whose outputs and torch.distributed calls are recorded
    def lsd(exchange):
        fn = pd.build_distributed_sort(mesh, N_LOCAL, width=8, exchange=exchange,
                                       capacity_factor=1.5, overlap_tile=OVERLAP_TILE)

        def run():
            out, overflow = fn(local["keys"])
            return {"keys": out}, [torch.full((1,), N_LOCAL)] * L, overflow
        return run

    def sample(reassembly):
        fn, _ = ss.build_sample_sort(mesh, N_LOCAL, capacity_factor=1.5, reassembly=reassembly)

        def run():
            out, counts, overflow = fn(local["keys"])
            return {"keys": out}, counts, overflow
        return run

    def sample_kv():
        fn, _ = ss.build_sample_sort_kv(mesh, N_LOCAL, LANES, capacity_factor=1.5)

        def run():
            k, v, counts, overflow = fn(local["keys"], local["vals"])
            return {"keys": k, "vals": v}, counts, overflow
        return run

    def sample_64():
        fn, _ = ss.build_sample_sort_64(mesh, N_LOCAL, capacity_factor=1.5)

        def run():
            hi, lo, counts, overflow = fn(local["hi"], local["keys"])
            return {"hi": hi, "lo": lo}, counts, overflow
        return run

    def aggregate(op):
        fn, _ = pp.build_hash_aggregate(mesh, AGG_LOCAL, op=op)

        def run():
            gk, ga, ng, overflow = fn(local["agg_keys"], local["agg_vals"], ones)
            return {"keys": gk, "aggs": ga}, ng, overflow
        return run

    paths = {
        "lsd alltoall": lambda: lsd("alltoall"),
        "lsd overflow": lambda: lsd("overflow"),
        "lsd gather": lambda: lsd("gather"),
        "lsd rdma": lambda: lsd("rdma"),
        "lsd rdma_overlap": lambda: lsd("rdma_overlap"),
        "sample sort": lambda: sample("sort"),
        "sample merge": lambda: sample("merge"),
        "sample kv": sample_kv,
        "sample 64": sample_64,
        "aggregate sum": lambda: aggregate("sum"),
        "aggregate count": lambda: aggregate("count"),
    }
    calls = count_collectives()
    arrays, report = {}, {"calls": {}, "overflow": {}, "errors": []}
    for name, build in paths.items():
        run = build()
        calls[0] = 0
        outs, counts, overflow = run()
        report["calls"][name] = calls[0]
        report["overflow"][name] = int(overflow)
        for i in range(L):
            c = int(counts[i])
            arrays[f"{name}|{mesh.first + i}|count"] = np.array(c)
            for what, bufs in outs.items():
                arrays[f"{name}|{mesh.first + i}|{what}"] = bufs[i][:c].numpy()

    import gpu_radix_sort_tpu_torch as port

    keys, vals = data["keys"], data["vals"]
    entries = {
        "sort_distributed": lambda: port.sort_distributed(keys, mesh=mesh),
        "sort_distributed_sample": lambda: port.sort_distributed_sample(keys, mesh=mesh),
        "sort_key_value_distributed": lambda: port.sort_key_value_distributed(
            keys, vals, mesh=mesh),
        "sort_distributed_64": lambda: port.sort_distributed_64(
            keys.to(torch.uint64), mesh=mesh),
        "sort_key_value_distributed_64": lambda: port.sort_key_value_distributed_64(
            keys.to(torch.uint64), vals, mesh=mesh),
        "hash_aggregate_distributed": lambda: port.hash_aggregate_distributed(
            keys, op="count", mesh=mesh),
    }
    for name, call in entries.items():
        try:
            call()
        except ValueError as e:
            if "build_" in str(e):
                report["errors"].append(name)

    report["shm_left"] = os.listdir(peer_memory.SHM_ROOT)
    np.savez(f"{out_dir}/{pid}.npz", **arrays)
    with open(f"{out_dir}/{pid}.json", "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    print(f"CHILD_OK {pid}", flush=True)


if __name__ == "__main__":
    main()
