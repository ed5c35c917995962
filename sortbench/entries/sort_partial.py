"""``ops.radix_sort.sort_partial(keys, offset, width)``: the digit sort.

The upstream's ``gpuPartial`` (invokers.cu:15): keys sorted by one digit,
stably by input order within a digit, and the upstream's group boundaries.
At 256Mi keys on the card it runs the binning passes (B5,
``binning_kernel``) and the PyTorch ops around them, and neither B1 nor B2.
Every output key, in stable order, and every boundary is compared.
"""

from __future__ import annotations

import torch

from sortbench import peaks, reference
from sortbench.keys import make_shards

LIMITS = {"wrong_keys": 0, "wrong_boundaries": 0}  # exact


def _digit(cell):
    return int(cell.params["offset"]), int(cell.params["width"])


def program(cell, devices):
    from gpu_radix_sort_tpu_torch.ops.radix_sort import sort_partial

    offset, width = _digit(cell)
    stable = bool(cell.params.get("stable", True))
    return lambda inputs: sort_partial(inputs[0], offset, width, stable=stable)


def control(cell, devices):
    """The port's own unstable route (the upstream's checked contract:
    groups in order and the same keys, any order within a group)."""
    from gpu_radix_sort_tpu_torch.ops.radix_sort import sort_partial

    offset, width = _digit(cell)
    return lambda inputs: sort_partial(inputs[0], offset, width, stable=False)


def keys_per_call(cell, devices) -> int:
    return cell.keys_per_card


def bytes_per_card(cell) -> int:
    return peaks.sort_bytes(cell.keys_per_card, extra_out=4 << _digit(cell)[1])


def compare(cell, seed, devices, outputs) -> dict:
    offset, width = _digit(cell)
    keys = make_shards(seed, cell.keys_per_card, devices[:1])[0]
    want, counts = reference.sort_by_digit(keys, offset, width)
    del keys
    want_b = torch.from_numpy(reference.boundaries(counts.cpu().numpy(), want.numel()))
    wrong_keys = wrong_b = 0
    for out in outputs:
        got, b = out if isinstance(out, tuple) and len(out) == 2 else (out, None)
        wrong_keys += reference.mismatches(got, want)
        if isinstance(b, torch.Tensor) and b.numel() == want_b.numel():
            b = b.cpu().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
            wrong_b += int((b != want_b).sum())
        else:
            wrong_b += want_b.numel()
    return {"wrong_keys": (wrong_keys, LIMITS["wrong_keys"]),
            "wrong_boundaries": (wrong_b, LIMITS["wrong_boundaries"])}
