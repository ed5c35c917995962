"""Mesh sorts over a single-controller list of devices (port of
``gpu_radix_sort_tpu/parallel``): the LSD sort with the collective
exchanges and the ragged exchanges of kernels B6 and B7."""

from .distributed import OverflowError_, build_distributed_sort, sort_distributed
from .mesh import KEY_AXIS, KeyMesh, key_mesh

__all__ = [
    "sort_distributed",
    "build_distributed_sort",
    "OverflowError_",
    "key_mesh",
    "KeyMesh",
    "KEY_AXIS",
]
