"""``ops.radix_sort.sort_full(keys)``: the full ascending sort on one card.

The headline sort: on the card it runs the tile pass (B1,
``block_sort_kernel``) and one merge level (B2, ``merge_level_kernel``)
for each doubling of the run length.  Every output key is compared.
"""

from __future__ import annotations

from sortbench import peaks, reference
from sortbench.keys import make_shards

LIMITS = {"wrong_keys": 0}  # an exact sort


def program(cell, devices):
    from gpu_radix_sort_tpu_torch.ops.radix_sort import sort_full

    return lambda inputs: sort_full(inputs[0])


def control(cell, devices):
    return lambda inputs: reference.sort_full_float32(inputs[0])


def keys_per_call(cell, devices) -> int:
    return cell.keys_per_card


def bytes_per_card(cell) -> int:
    return peaks.sort_bytes(cell.keys_per_card)


def compare(cell, seed, devices, outputs) -> dict:
    want = reference.sort_full(make_shards(seed, cell.keys_per_card, devices[:1])[0])
    return {"wrong_keys": (sum(reference.mismatches(out, want) for out in outputs),
                           LIMITS["wrong_keys"])}
