"""gpu_radix_sort_tpu_torch — the PyTorch and CUDA port of gpu_radix_sort_tpu.

The same public surface as the JAX package, on PyTorch tensors: sorts run on
the device of the tensor they are given.  On a CUDA tensor the sorts go
through kernels written by hand for Hopper (``csrc/``, built with nvcc at
first use); on a CPU tensor through those kernels' plain PyTorch versions.
The mesh sorts run over a list of devices held by one process
(``parallel/``); the table operators (hash partition, filter, group
aggregate) are in ``ops/table.py``; the storage plane -- DistribArrays
(``data/``) and the storage round loop with in-process and subprocess
workers, checkpoint and resume (``parallel/storage_sort.py``,
``parallel/serverless.py``) -- runs the reference's distributed sort.  This
package imports neither jax nor the JAX package.
"""

from .models.pipelines import (
    DistributedSortPipeline,
    FullSortPipeline,
    PartialSortPipeline,
)
from .ops.bits import extract_digits
from .ops.boundaries import compute_boundaries, counts_to_boundaries, digit_counts
from .ops.radix_sort import (
    get_default_strategy,
    set_default_strategy,
    sort_by_digits,
    sort_full,
    sort_full_u64,
    sort_key_value,
    sort_key_value_by_digits,
    sort_key_value_u64,
    sort_partial,
    sort_partial_counts,
    sort_partial_counts_u64,
    sort_partial_u64,
)
from .parallel import (
    WorkerPool,
    build_distributed_sort,
    key_mesh,
    make_local_worker,
    resume_sort_distrib,
    sort_distrib_from_raw,
    sort_distrib_from_raw_kv,
    sort_distrib_from_raw_kv64,
    sort_distrib_from_raw_u64,
    sort_distributed,
)
from .utils.config import SortConfig
from .utils.timers import SortStats
from .utils.keygen import (
    Pcg32,
    generate_keys,
    generate_payloads,
    generate_zipf_keys,
    reset_global_stream,
)

__version__ = "0.1.0"

__all__ = [
    "sort_full",
    "sort_full_u64",
    "sort_partial",
    "sort_partial_u64",
    "sort_partial_counts",
    "sort_partial_counts_u64",
    "sort_by_digits",
    "sort_key_value",
    "sort_key_value_by_digits",
    "sort_key_value_u64",
    "set_default_strategy",
    "get_default_strategy",
    "compute_boundaries",
    "digit_counts",
    "counts_to_boundaries",
    "extract_digits",
    "Pcg32",
    "generate_keys",
    "reset_global_stream",
    "generate_zipf_keys",
    "generate_payloads",
    "sort_distributed",
    "build_distributed_sort",
    "key_mesh",
    "sort_distrib_from_raw",
    "sort_distrib_from_raw_kv",
    "sort_distrib_from_raw_u64",
    "sort_distrib_from_raw_kv64",
    "resume_sort_distrib",
    "make_local_worker",
    "WorkerPool",
    "SortConfig",
    "SortStats",
    "FullSortPipeline",
    "PartialSortPipeline",
    "DistributedSortPipeline",
    "__version__",
]
