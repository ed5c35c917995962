"""gpu_radix_sort_tpu_torch — the PyTorch and CUDA port of gpu_radix_sort_tpu.

The same public surface as the JAX package, on PyTorch tensors: sorts run on
the device of the tensor they are given.  On a CUDA tensor the sorts go
through kernels written by hand for Hopper (``csrc/``, built with nvcc at
first use); on a CPU tensor through those kernels' plain PyTorch versions.
This package imports neither jax nor the JAX package.
"""

from .models.pipelines import FullSortPipeline
from .ops.bits import extract_digits
from .ops.boundaries import compute_boundaries
from .ops.radix_sort import (
    get_default_strategy,
    set_default_strategy,
    sort_by_digits,
    sort_full,
    sort_partial,
)
from .utils.keygen import Pcg32, generate_keys, reset_global_stream

__version__ = "0.1.0"

__all__ = [
    "sort_full",
    "sort_partial",
    "sort_by_digits",
    "set_default_strategy",
    "get_default_strategy",
    "compute_boundaries",
    "extract_digits",
    "Pcg32",
    "generate_keys",
    "reset_global_stream",
    "FullSortPipeline",
    "__version__",
]
