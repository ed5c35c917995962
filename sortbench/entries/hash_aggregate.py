"""``parallel.pipeline.build_hash_aggregate``: COUNT(*) GROUP BY key on one card.

Set-up builds ``fn = build_hash_aggregate(key_mesh([card]), keys_per_card,
op=...)`` and a ``row_valid`` of all True; each call is ``fn([rows],
[rows], [row_valid])`` (the values, which a count ignores, are the rows).
The rows are the configuration's Zipf keys, made from the harness's
uniform shard by ``zipf.py`` on the first call, a warm-up call, and then
held: the timed work is the port's aggregate alone (its hash order, the
onesweep sort of the hashes, two combines, the splitters and exchange over
the one rank, and the final key-value sort of the P * capacity rows).

The comparison makes the rows again from the seed and counts them with
``reference_group_count.py``: ``wrong_groups`` is the group keys that
differ from the reference's, position by position, plus the difference
between the group counts; ``wrong_counts`` the counts that differ;
``overflow`` the port's overflow count.  Each limit is 0.
"""

from __future__ import annotations

import torch

from sortbench import zipf
from sortbench.harness import log
from sortbench.keys import make_shards
from sortbench.reference_group_count import group_count

LIMITS = {"wrong_groups": 0, "wrong_counts": 0, "overflow": 0}  # exact
KEY_BYTES = 4
GROUP_BYTES = 8  # a group's key and its count


def _alpha(cell) -> float:
    return float(cell.config["zipf_alpha"])


def _program(cell, devices, lost: int):
    """The timed call with the shard's last ``lost`` rows marked invalid."""
    from gpu_radix_sort_tpu_torch.parallel.mesh import key_mesh
    from gpu_radix_sort_tpu_torch.parallel.pipeline import build_hash_aggregate

    card, n = devices[0], cell.keys_per_card
    fn, _ = build_hash_aggregate(key_mesh([card]), n, op=cell.params["op"])
    valid = torch.ones(n, dtype=torch.bool, device=card)
    if lost:
        valid[n - lost:] = False
    held = [None, None]  # the shard, and the rows made from it

    def call(inputs):
        if held[0] is not inputs[0]:
            held[:] = [inputs[0], zipf.rows(inputs[0], _alpha(cell))]
        rows = held[1]
        return fn([rows], [rows], [valid])

    return call


def program(cell, devices):
    return _program(cell, devices, lost=0)


def control(cell, devices):
    """One row lost: the shard's last row marked invalid."""
    return _program(cell, devices, lost=1)


def keys_per_call(cell, devices) -> int:
    return cell.keys_per_card


def bytes_per_card(cell) -> int:
    """Each row read once and each group's key and count written once, at
    the maker's expected group count."""
    n = cell.keys_per_card
    return KEY_BYTES * n + GROUP_BYTES * round(zipf.expected_groups(n, _alpha(cell)))


def _groups(out):
    """(keys, counts) of the first ngroups rows, as int64, and the
    overflow count of an output; None where it has not that form."""
    try:
        keys, counts, ngroups, overflow = out
        ng = int(ngroups[0].reshape(-1)[0])
        k, c = keys[0][:ng], counts[0][:ng]
        mask = 0xFFFFFFFF
        return (k.view(torch.int32).to(torch.int64) & mask,
                c.view(torch.int32).to(torch.int64) & mask, int(overflow))
    except (TypeError, ValueError, IndexError, RuntimeError):
        return None


def compare(cell, seed, devices, outputs) -> dict:
    rows = zipf.rows(make_shards(seed, cell.keys_per_card, devices[:1])[0], _alpha(cell))
    want_k, want_c = group_count(rows)
    del rows
    distinct = want_k.numel()
    log(f"groups {distinct} (the maker expects "
        f"{zipf.expected_groups(cell.keys_per_card, _alpha(cell))}), hot key "
        f"{int(want_c.max()) / cell.keys_per_card} of the rows")
    wrong_g = wrong_c = overflow = 0
    for out in outputs:
        got = _groups(out)
        if got is None:
            wrong_g, wrong_c, overflow = wrong_g + distinct, wrong_c + distinct, overflow + 1
            continue
        k, c, ov = got
        ng = k.numel()
        m = min(ng, distinct)
        k, c = k[:m].to(want_k.device), c[:m].to(want_c.device)
        wrong_g += int((k != want_k[:m]).sum()) + abs(ng - distinct)
        wrong_c += int((c != want_c[:m]).sum())
        overflow += ov
    return {"wrong_groups": (wrong_g, LIMITS["wrong_groups"]),
            "wrong_counts": (wrong_c, LIMITS["wrong_counts"]),
            "overflow": (overflow, LIMITS["overflow"])}
