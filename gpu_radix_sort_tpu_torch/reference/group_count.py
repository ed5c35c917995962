"""COUNT(*) GROUP BY key, plainly: the reference of the hash aggregate's
count (``parallel/pipeline.py``, ``op="count"``) on one rank.

It imports ``torch`` alone.  The result has the contract of one rank's
output: every distinct key once, in ascending key order (the final merge
sorts by key), with the exact number of its rows.  PyTorch orders no
uint32, so the keys are taken as their int64 image, 0 ... 2^32 - 1.
"""

from __future__ import annotations

import torch


def group_count(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(distinct keys ascending, rows of each), both int64, of 1-D uint32
    (or int32, read as their bits) ``keys``."""
    if keys.dtype not in (torch.uint32, torch.int32) or keys.dim() != 1:
        raise ValueError(f"expected 1-D uint32 keys, got {keys.dtype} of shape "
                         f"{tuple(keys.shape)}")
    image = keys.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.unique(image, sorted=True, return_counts=True)
