"""Distributed sorts (port of ``gpu_radix_sort_tpu/parallel``): the mesh LSD
sort over a single-controller list of devices or a process group
(``multihost.py``), with the collective exchanges and, on a single
controller, the ragged exchanges of kernels B6 and B7; the mesh sample
sort (PSRS) for 32-bit, key-value and 64-bit keys; the distributed hash
aggregate (hash-partition -> filter -> aggregate); and the storage plane
-- the round loop over DistribArrays with in-process and subprocess
workers, checkpoint and resume."""

from .bucket_reader import BucketReader, ReadOrder
from .distributed import OverflowError_, build_distributed_sort, sort_distributed
from .mesh import KEY_AXIS, KeyMesh, host_chip_mesh, key_mesh
from .pipeline import build_hash_aggregate, hash_aggregate_distributed
from .sample_sort import (
    build_sample_sort,
    build_sample_sort_kv,
    build_sample_sort_kv64,
    sort_distributed_64,
    sort_distributed_sample,
    sort_key_value_distributed,
    sort_key_value_distributed_64,
)
from .serverless import (
    WorkerPool,
    build_event,
    handle_event,
    invoke_subprocess,
    make_subprocess_worker,
    part_ref_to_wire,
    wire_to_part_ref,
)
from .storage_sort import (
    DistribWorker,
    load_checkpoint,
    local_distrib_worker,
    local_distrib_worker_kv,
    make_kv_worker,
    make_local_worker,
    resume_sort_distrib,
    sort_distrib_from_arr,
    sort_distrib_from_raw,
    sort_distrib_from_raw_kv,
    sort_distrib_from_raw_kv64,
    sort_distrib_from_raw_u64,
)

__all__ = [
    "sort_distributed",
    "build_distributed_sort",
    "OverflowError_",
    "build_sample_sort",
    "build_sample_sort_kv",
    "build_sample_sort_kv64",
    "sort_distributed_64",
    "sort_distributed_sample",
    "sort_key_value_distributed",
    "sort_key_value_distributed_64",
    "build_hash_aggregate",
    "hash_aggregate_distributed",
    "key_mesh",
    "host_chip_mesh",
    "KeyMesh",
    "KEY_AXIS",
    "BucketReader",
    "ReadOrder",
    "DistribWorker",
    "local_distrib_worker",
    "local_distrib_worker_kv",
    "make_kv_worker",
    "make_local_worker",
    "sort_distrib_from_arr",
    "sort_distrib_from_raw",
    "sort_distrib_from_raw_kv",
    "sort_distrib_from_raw_kv64",
    "sort_distrib_from_raw_u64",
    "resume_sort_distrib",
    "load_checkpoint",
    "WorkerPool",
    "build_event",
    "handle_event",
    "invoke_subprocess",
    "make_subprocess_worker",
    "part_ref_to_wire",
    "wire_to_part_ref",
]
