"""COUNT(*) GROUP BY key through the port's hash aggregate
(``parallel/pipeline.py``, ``build_hash_aggregate(..., op="count")``)
against its plain reference (``reference/group_count.py``), on one rank and
on four ranks of the CPU, and the ``grs.aggregate.*`` spans of a call.

Keys are Zipf(1.2) and Zipf(1.01) (``utils/keygen.generate_zipf_keys``),
so hot keys hold a large share of a rank, and one shard of a single key.
Every group key and count is compared exactly.  A rank's groups come out
in ascending key order; the ranks split the keys by hash, so the four
ranks' groups are joined and put in key order before the comparison."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpu_radix_sort_tpu_torch.parallel.mesh import key_mesh
from gpu_radix_sort_tpu_torch.parallel.pipeline import build_hash_aggregate
from gpu_radix_sort_tpu_torch.reference import group_count as ref
from gpu_radix_sort_tpu_torch.utils import timers
from gpu_radix_sort_tpu_torch.utils.keygen import generate_zipf_keys

N_LOCAL = 1 << 13  # rows a rank
ALPHAS = {"zipf1.2": 1.2, "zipf1.01": 1.01}
ONE_KEY = 0xFFFFFFFF  # the largest key, which is also the final merge's pad word


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shards(kind: str, P: int) -> list[torch.Tensor]:
    n = N_LOCAL * P
    if kind == "one_key":
        keys = np.full(n, ONE_KEY, dtype=np.uint32)
    else:
        keys = generate_zipf_keys(n, alpha=ALPHAS[kind], seed=25)
    return list(torch.from_numpy(keys).split(N_LOCAL))


def _count(shards: list[torch.Tensor]):
    P = len(shards)
    fn, _ = build_hash_aggregate(key_mesh([torch.device("cpu")] * P), N_LOCAL, op="count")
    return fn(shards, shards, [torch.ones(N_LOCAL, dtype=torch.bool)] * P)


def _int64(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("kind", ["zipf1.2", "zipf1.01", "one_key"])
def test_count_equals_the_reference(kind, P):
    shards = _shards(kind, P)
    group_keys, counts, ngroups, overflow = _count(shards)
    assert int(overflow) == 0
    keys, rows = [], []
    for k, c, ng in zip(group_keys, counts, ngroups):
        k, c = _int64(k[:int(ng)]), _int64(c[:int(ng)])
        assert bool((k[1:] > k[:-1]).all())  # each rank in ascending key order
        keys.append(k)
        rows.append(c)
    keys, rows = torch.cat(keys), torch.cat(rows)
    order = torch.argsort(keys)
    want_keys, want_rows = ref.group_count(torch.cat(shards))
    assert torch.equal(keys[order], want_keys)
    assert torch.equal(rows[order], want_rows)
    assert int(want_rows.sum()) == N_LOCAL * P


def test_reference_contract():
    keys = torch.tensor([5, -1, 3, 5, -1, -1], dtype=torch.int32).view(torch.uint32)
    got_keys, got_rows = ref.group_count(keys)
    assert got_keys.tolist() == [3, 5, 0xFFFFFFFF] and got_rows.tolist() == [1, 2, 3]
    assert ref.group_count(keys.view(torch.int32))[0].tolist() == got_keys.tolist()
    with pytest.raises(ValueError):
        ref.group_count(keys.to(torch.int64))
    with pytest.raises(ValueError):
        ref.group_count(keys.view(torch.int32).view(2, 3))


def _spans(prof) -> Counter:
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


@pytest.mark.parametrize("P", [1, 4])
def test_each_phase_is_a_span_under_the_call(P):
    shards = _shards("zipf1.2", P)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _count(shards)
    got = _spans(prof)
    phases = {name: k for (name, parent), k in got.items()
              if name.startswith("grs.aggregate.") and parent == "grs.aggregate"}
    # the splitters and the exchange once a call; the hash order and the
    # merge once a rank, the combine twice a rank (the local and the final)
    assert phases == {"grs.aggregate.hash_order": P, "grs.aggregate.combine": 2 * P,
                      "grs.aggregate.splitters": 1, "grs.aggregate.exchange": 1,
                      "grs.aggregate.merge": P}
    assert got["grs.aggregate", None] == 1
    assert got["grs.sort_full", "grs.aggregate.hash_order"] == P  # the hashes' sort
    assert got["grs.binning.place", "grs.aggregate.merge"] > 0  # the final kv sort
    outside = {name for (name, parent) in got if parent is None}
    assert outside == {"grs.aggregate"}


def test_no_span_opens_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a span {name} opened with no profiler running")

    monkeypatch.setattr(timers._autograd_profiler, "record_function", refuse)
    _count(_shards("zipf1.2", 1))
