"""``parallel.distributed.build_distributed_sort``: the mesh LSD sort.

Set-up builds ``fn = build_distributed_sort(key_mesh(cards), keys_per_card,
width=..., exchange=...)`` once, over a single controller of every card
the cell holds; each call is ``fn(shards)``: 32/width rounds, each a local
sort and an exchange between the cards.  Every shard's keys are compared
with the global sort cut into shards, and the overflow count with 0.
"""

from __future__ import annotations

import torch

from sortbench import peaks, reference
from sortbench.keys import make_shards

LIMITS = {"wrong_keys": 0, "overflow": 0}  # exact, and no key dropped


def program(cell, devices):
    from gpu_radix_sort_tpu_torch.parallel.distributed import build_distributed_sort
    from gpu_radix_sort_tpu_torch.parallel.mesh import key_mesh

    return build_distributed_sort(
        key_mesh(devices), cell.keys_per_card, width=int(cell.params["width"]),
        exchange=cell.params.get("exchange", "auto"))


def control(cell, devices):
    def sort(inputs):
        zero = torch.zeros((), dtype=torch.int32, device=inputs[0].device)
        return reference.sort_shards_float32(inputs, inputs[0].device), zero

    return sort


def keys_per_call(cell, devices) -> int:
    return cell.keys_per_card * len(devices)


def bytes_per_card(cell) -> int:
    return peaks.sort_bytes(cell.keys_per_card)


def compare(cell, seed, devices, outputs) -> dict:
    want = reference.sort_shards(make_shards(seed, cell.keys_per_card, devices),
                                 devices[0])
    wrong = overflow = 0
    for out in outputs:
        shards, count = out if isinstance(out, tuple) and len(out) == 2 else (out, None)
        shards = list(shards) if isinstance(shards, (list, tuple)) else []
        if len(shards) != len(want):
            wrong += sum(w.numel() for w in want)
        else:
            wrong += sum(reference.mismatches(s, w) for s, w in zip(shards, want))
        overflow += int(count) if isinstance(count, torch.Tensor) else 1
    return {"wrong_keys": (wrong, LIMITS["wrong_keys"]),
            "overflow": (overflow, LIMITS["overflow"])}
