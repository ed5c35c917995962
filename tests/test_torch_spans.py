"""The port's spans (``utils/timers.span``): off without a profiler, and under
``torch.profiler`` one ``record_function`` range a step, nested as the
program's layers are (``grs.mesh_sort`` > ``grs.round`` > ``grs.sort_full``
and ``grs.exchange``; ``grs.sort_partial`` > ``grs.binning.stage_a``,
``grs.binning.place`` and ``grs.boundaries``).  Small sizes on the CPU,
where the kernels' plain versions run."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpu_radix_sort_tpu_torch.ops.radix_sort import sort_full, sort_partial
from gpu_radix_sort_tpu_torch.parallel.distributed import build_distributed_sort
from gpu_radix_sort_tpu_torch.parallel.mesh import key_mesh
from gpu_radix_sort_tpu_torch.utils import timers
from gpu_radix_sort_tpu_torch.utils.timers import span

N_FULL = 1 << 15  # past one block: the tile pass and the merge levels
N_PARTIAL = 20_000  # past one block: two binning passes of 4 bits
N_LOCAL = 1 << 12  # a rank's keys in the two-rank mesh sort
FUSED = ("alltoall", "overflow", "rdma")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keys(n: int, seed: int = 22) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32))


def _mesh_sort(exchange: str):
    fn = build_distributed_sort(key_mesh([torch.device("cpu")] * 2), N_LOCAL, width=8,
                                exchange=exchange)
    return lambda: fn([_keys(N_LOCAL, 1), _keys(N_LOCAL, 2)])


CALLS = {
    "sort_full": lambda: sort_full(_keys(N_FULL)),
    "sort_partial": lambda: sort_partial(_keys(N_PARTIAL), 0, 8),
    "mesh_sort": lambda: _mesh_sort("alltoall")(),
}


def _nesting(prof) -> Counter:
    """(span, the innermost span around it) of every ``grs.`` span, counted."""
    spans = sorted(((e.start_ns(), e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("grs.") and e.activity_type() == "user_annotation"),
                   key=lambda s: (s[0], -s[1]))
    stack, pairs = [], Counter()
    for t0, t1, name in spans:
        while stack and stack[-1][1] < t1:
            stack.pop()
        pairs[name, stack[-1][2] if stack else None] += 1
        stack.append((t0, t1, name))
    return pairs


def _traced(call) -> Counter:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    return _nesting(prof)


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert span("grs.a") is span("grs.b") is timers._OFF
    with span("grs.a") as got:
        assert got is None


@pytest.mark.parametrize("call", sorted(CALLS))
def test_no_span_is_recorded_without_a_profiler(call, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a span {name} opened with no profiler running")

    monkeypatch.setattr(timers._autograd_profiler, "record_function", refuse)
    CALLS[call]()


def test_span_under_a_profiler_is_a_user_annotation():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("grs.outer"):
            with span("grs.inner"):
                torch.ones(8).sum()
    assert _nesting(prof) == {("grs.outer", None): 1, ("grs.inner", "grs.outer"): 1}


@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32])  # int32 through the codec
def test_sort_full_span(dtype):
    keys = _keys(N_FULL).view(dtype)
    assert _traced(lambda: sort_full(keys)) == {("grs.sort_full", None): 1}


def test_sort_partial_spans():
    assert _traced(CALLS["sort_partial"]) == {
        ("grs.sort_partial", None): 1,
        ("grs.binning.stage_a", "grs.sort_partial"): 2,
        ("grs.binning.place", "grs.sort_partial"): 2,
        ("grs.boundaries", "grs.sort_partial"): 1,
    }


@pytest.mark.parametrize("exchange", ["alltoall", "overflow", "rdma", "gather", "rdma_overlap"])
def test_mesh_sort_spans(exchange):
    got = _traced(_mesh_sort(exchange))
    rounds = 4 + (exchange in FUSED)  # the fused loop's last round reassembles
    assert got["grs.mesh_sort", None] == 1
    assert got["grs.round", "grs.mesh_sort"] == rounds
    assert got["grs.exchange", "grs.round"] == 4
    assert {parent for _, parent in got} <= {None, "grs.mesh_sort", "grs.round"}
    if exchange in FUSED:  # each round one sort_full a rank
        assert got["grs.sort_full", "grs.round"] == 2 * rounds
        assert sum(got.values()) == 1 + rounds + 4 + 2 * rounds


def test_unfused_alltoall_rounds_hold_the_exchange_and_the_reassembly():
    fn = build_distributed_sort(key_mesh([torch.device("cpu")] * 2), N_LOCAL, width=8,
                                exchange="alltoall", fuse_rounds=False)
    got = _traced(lambda: fn([_keys(N_LOCAL, 1), _keys(N_LOCAL, 2)]))
    assert got["grs.round", "grs.mesh_sort"] == 4
    assert got["grs.exchange", "grs.round"] == 4
    # the reassembly: a stable sort by 9-bit tags, passes of 4, 4 and 1 bits
    assert got["grs.binning.stage_a", "grs.round"] == 4 * 2 * 3
    assert got["grs.binning.place", "grs.round"] == 4 * 2 * 3

