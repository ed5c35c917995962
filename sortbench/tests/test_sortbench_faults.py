"""The check must fail: the control, and the timed path broken underneath.

Each fault wraps the cell's real program and breaks what it returns, the
way a faulty later change could: a sort that returns its input unchanged,
one that leaves half of the keys out, a mesh sort without its exchange
between cards, and an answer altered where it is produced (two keys
swapped, one boundary changed, an overflow reported).  The harness runs
everything else of a run as it is.
"""

import pytest
import torch

from sortbench import cells

from .helpers import CELLS, run_small


def _keys(out):
    """The keys tensor of an entry's output, and a function that puts a
    changed one back in its place."""
    if isinstance(out, torch.Tensor):
        return out, lambda k: k
    first, rest = out
    if isinstance(first, torch.Tensor):
        return first, lambda k: (k, rest)
    return first[0], lambda k: ([k, *first[1:]], rest)


def _unchanged(out, inputs):
    keys, put = _keys(out)
    return put(inputs[0].clone())


def _half_left_out(out, inputs):
    keys, put = _keys(out)
    keys = keys.clone()
    half = keys.numel() // 2
    keys[half:] = inputs[0].to(keys.device)[half:]
    return put(keys)


def _keys_swapped(out, inputs):
    keys, put = _keys(out)
    keys = keys.clone().view(torch.int32)
    i = int(torch.argmax((keys[1:] != keys[:-1]).to(torch.int32)))
    keys[[i, i + 1]] = keys[[i + 1, i]]
    return put(keys.view(torch.uint32))


def _boundary_changed(out, inputs):
    keys, b = out
    b = b.clone().view(torch.int32)
    b[5] += 1
    return keys, b.view(torch.uint32)


def _overflow_reported(out, inputs):
    shards, count = out
    return shards, count + 1


FAULTS = {
    "unchanged": (_unchanged, CELLS),
    "half_left_out": (_half_left_out, CELLS),
    "keys_swapped": (_keys_swapped, CELLS),
    "boundary_changed": (_boundary_changed, ["u32_256Mi_1card.partial_w8"]),
    "overflow_reported": (_overflow_reported, ["u32_1Gi_4card.lsd_w8"]),
}
CASES = [(f, c) for f, (_, names) in FAULTS.items() for c in names]


def _planted(fault):
    def program(cell, devices):
        real = cell.entry.program(cell, devices)
        return lambda inputs: fault(real(inputs), inputs)

    return program


@pytest.mark.parametrize("fault,name", CASES)
def test_fault_fails_the_check(fault, name):
    line = run_small(name, program=_planted(FAULTS[fault][0]))
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["compared"].values())


def test_exchange_left_out_fails_the_check():
    """Each card sorts its own shard and nothing crosses between them."""
    def program(cell, devices):
        from gpu_radix_sort_tpu_torch.ops.radix_sort import sort_full

        def call(inputs):
            zero = torch.zeros((), dtype=torch.int32, device=inputs[0].device)
            return [sort_full(s) for s in inputs], zero

        return call

    line = run_small("u32_1Gi_4card.lsd_w8", program=program)
    assert line["correct"] is False
    assert line["compared"]["wrong_keys"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(name):
    # enough keys that some lie within 256 of each other
    line = run_small(name, program=cells.load(name).entry.control, keys_per_card=1 << 16)
    assert line["correct"] is False
    assert line["compared"]["wrong_keys"]["value"] > 0


def test_failed_call_ends_the_run_not_correct():
    def program(cell, devices):
        def call(inputs):
            raise RuntimeError("planted")

        return call

    with pytest.raises(RuntimeError):  # set-up's warm-up calls it first
        run_small(CELLS[0], program=program)

    def flaky(cell, devices):
        real = cell.entry.program(cell, devices)
        calls = []

        def call(inputs):
            calls.append(1)
            if len(calls) > 5:
                raise RuntimeError("planted")
            return real(inputs)

        return call

    line = run_small(CELLS[0], program=flaky, seconds=5)
    assert line["correct"] is False and line["failed"] == 1
