"""Distributed data plane: named arrays of append-only byte partitions.

Port of ``gpu_radix_sort_tpu/data`` (the reference's DistribArray
abstraction, benchmark/pkg/data/, faasTest/pylibsort/data.py) with three
backends: memory (in-process), file (on-disk, the reference's format, the
subprocess workers' wire protocol) and device (partitions as uint8 tensors
on the card).
"""

from .interface import (
    ArrayFactory,
    CapacityError,
    DistribArray,
    DistribArrayShape,
    PartReader,
    PartRef,
    PartWriter,
    create_shape,
    create_shape_uniform,
)
from .mem import GLOBAL_REGISTRY, MemArrayFactory, MemDistribArray
from .file import FileArrayFactory, FileDistribArray
from .device import DeviceArrayFactory, DeviceDistribArray
from .helpers import fetch_part_refs, fetch_part_refs_u32

__all__ = [
    "ArrayFactory",
    "CapacityError",
    "DistribArray",
    "DistribArrayShape",
    "PartReader",
    "PartRef",
    "PartWriter",
    "create_shape",
    "create_shape_uniform",
    "MemArrayFactory",
    "MemDistribArray",
    "GLOBAL_REGISTRY",
    "FileArrayFactory",
    "FileDistribArray",
    "DeviceArrayFactory",
    "DeviceDistribArray",
    "fetch_part_refs",
    "fetch_part_refs_u32",
]
