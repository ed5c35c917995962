"""Data-plane helpers: PartRef gather.

Port of ``gpu_radix_sort_tpu/data/helpers.py``.  Reference analog:
FetchPartRefs (benchmark/pkg/data/helpers.go:10-38) and pylibsort's
readPartRefs (faasTest/pylibsort/data.py:265-278): assemble a list of
byte-range references into one contiguous host buffer -- the input assembly
step of every worker whose arrays live on the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .interface import PartRef, iter_refs_bytes


def fetch_part_refs(refs: Sequence[PartRef]) -> bytearray:
    """Gather the referenced byte ranges, in order, into one buffer."""
    total = sum(r.nbyte for r in refs)
    out = bytearray(total)
    pos = 0
    for chunk in iter_refs_bytes(refs):
        out[pos : pos + len(chunk)] = chunk
        pos += len(chunk)
    return out


def fetch_part_refs_u32(refs: Sequence[PartRef]) -> np.ndarray:
    """Gather byte ranges and view them as uint32 keys (every nbyte must be
    4-aligned).  A zero-copy, writable view of the gathered buffer."""
    buf = fetch_part_refs(refs)
    if len(buf) % 4:
        raise ValueError(f"gathered {len(buf)} bytes, not a multiple of 4")
    return np.frombuffer(buf, dtype=np.uint32)
