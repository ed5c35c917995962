"""Entry points of a quick check: one compile-free step of the flagship
pipeline, and the multi-rank dryrun.

Port of the JAX repository's ``__graft_entry__.py`` (``entry`` and
``dryrun_multichip``).  JAX jits the distributed sort over a mesh of
``n_devices`` devices (virtual CPU devices where there are too few chips)
and runs one step of each sharded path on tiny shapes.  Here the ranks are
the visible cards, repeated to reach ``n_devices`` (ranks on one card share
it), or the CPU when asked, on a single-controller mesh; each path runs
once, with the JAX dryrun's seeds and sizes, and must be exact.

    python -c "from gpu_radix_sort_tpu_torch.dryrun import dryrun_multichip; dryrun_multichip(8)"
"""

from __future__ import annotations

import numpy as np
import torch

from .models.pipelines import DistributedSortPipeline, FullSortPipeline
from .parallel.distributed import build_distributed_sort, sort_distributed
from .parallel.mesh import key_mesh, shard, unshard
from .parallel.pipeline import hash_aggregate_distributed
from .parallel.sample_sort import (
    sort_distributed_64,
    sort_key_value_distributed,
    sort_key_value_distributed_64,
)
from .utils.keygen import Pcg32, generate_zipf_keys


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): one step of the flagship pipeline, a full sort of
    1M uint32 keys, on ``device``."""
    return FullSortPipeline(n=1 << 20, device=device).build()


def _ranks(n_devices: int, device) -> list[torch.device]:
    if device is not None:
        return [torch.device(device)] * n_devices
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip runs on the CUDA devices and none is available; "
                           "pass device='cpu' to run it on the CPU")
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> list[str]:
    """Runs every sharded path once over a mesh of ``n_devices`` ranks on
    tiny shapes (the visible cards, repeated to reach ``n_devices``, or
    ``device`` for every rank), exact against numpy; raises on a mismatch,
    prints one line naming what passed and returns the checks' names."""
    ranks = _ranks(n_devices, device)
    mesh = key_mesh(ranks)
    dev = ranks[0]
    passed = []

    def check(name: str, ok: bool) -> None:
        if not ok:
            raise AssertionError(f"dryrun_multichip({n_devices}): {name} mismatch")
        passed.append(name)

    def keys_of(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    # the mesh LSD sort (all rounds, capacity-bounded all-to-all exchange)
    fn, (example,) = DistributedSortPipeline(
        n_local=512, width=8, exchange="alltoall", mesh=mesh).build()
    out, overflow = fn(example)
    if int(overflow) != 0:
        raise AssertionError(f"dryrun_multichip({n_devices}): exchange capacity overflow")
    check("distributed LSD sort", np.array_equal(
        unshard(out).cpu().numpy(), np.sort(unshard(example).cpu().numpy())))

    # the stable key-value sample sort
    keys = Pcg32().fill(777)
    vals = np.arange(777, dtype=np.uint32).reshape(-1, 1)
    gk, gv = sort_key_value_distributed(keys_of(keys), keys_of(vals), mesh=mesh)
    order = np.argsort(keys, kind="stable")
    check("stable kv sample sort", np.array_equal(gk.cpu().numpy(), keys[order])
          and np.array_equal(gv.cpu().numpy(), vals[order]))

    # 64-bit keys: single-pass (hi, lo)-lane PSRS, keys-only and stable kv
    rng64 = np.random.default_rng(64)
    k64 = rng64.integers(0, 1 << 64, 2048, dtype=np.uint64)
    k64[:2] = [0, np.iinfo(np.uint64).max]
    check("64-bit distributed sort", np.array_equal(
        sort_distributed_64(keys_of(k64), mesh=mesh).cpu().numpy(), np.sort(k64)))
    v64 = np.arange(2048, dtype=np.uint32).reshape(-1, 1)
    gk64, gv64 = sort_key_value_distributed_64(keys_of(k64), keys_of(v64), mesh=mesh)
    o64 = np.argsort(k64, kind="stable")
    check("64-bit kv distributed sort", np.array_equal(gk64.cpu().numpy(), k64[o64])
          and np.array_equal(gv64.cpu().numpy(), v64[o64]))

    # the skew-aware hash aggregate
    zk = generate_zipf_keys(2000, alpha=1.3, seed=1)
    agg_k, agg_c = hash_aggregate_distributed(keys_of(zk), op="count", mesh=mesh)
    uk, uc = np.unique(zk, return_counts=True)
    o = np.argsort(agg_k, kind="stable")
    check("hash aggregate", np.array_equal(agg_k[o], uk)
          and np.array_equal(agg_c[o].astype(np.int64), uc))

    # the two-pass overflow exchange (capacity factor 1.0 + overflow slot)
    k2 = Pcg32(state=99).fill(4096)
    check("overflow-exchange sort", np.array_equal(
        sort_distributed(keys_of(k2), mesh=mesh, width=8, exchange="overflow").cpu().numpy(),
        np.sort(k2)))

    # width-16 fused rounds
    k16 = Pcg32(state=41).fill(4096)
    check("width-16 fused sort", np.array_equal(
        sort_distributed(keys_of(k16), mesh=mesh, width=16, exchange="alltoall",
                         capacity_factor=1.6).cpu().numpy(), np.sort(k16)))

    # the ragged exchange (B6: stores straight into the peers' buffers)
    k3 = Pcg32(state=7).fill(2048)
    check("rdma-exchange sort", np.array_equal(
        sort_distributed(keys_of(k3), mesh=mesh, width=8, exchange="rdma").cpu().numpy(),
        np.sort(k3)))

    # the overlapped exchange (B7) on min(4, n) ranks, two groups a rank, as
    # JAX runs it (its interpreter deadlocks at 8 devices on one core)
    n_ov = min(4, n_devices)
    mesh_ov = key_mesh(ranks[:n_ov])
    n_local_ov = 2048
    k4 = Pcg32(state=13).fill(n_local_ov * n_ov)
    fn_ov = build_distributed_sort(mesh_ov, n_local_ov, width=8, exchange="rdma_overlap",
                                   overlap_tile=1024)
    got4, ovf4 = fn_ov(shard(keys_of(k4), mesh_ov))
    check(f"rdma-overlap sort ({n_ov} ranks)", int(ovf4) == 0 and np.array_equal(
        unshard(got4).cpu().numpy(), np.sort(k4)))

    print(f"dryrun_multichip({n_devices}): {', '.join(passed)}: all exact over a "
          f"{n_devices}-rank mesh on {sorted({str(d) for d in ranks})}")
    return passed
