"""The skewed group-by cell, ``zipf12_256Mi_1card.agg_count``: its entry
through the harness on the CPU at small sizes, its control and planted
faults found not correct, its Zipf maker (``zipf.py``) against its own
expectation, its reference against the port's, and its readers on made-up
events."""

import ast
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from sortbench import cells, harness, spans, trace, zipf
from sortbench.keys import make_keys
from sortbench.reference_group_count import group_count

from .helpers import SEED, run_small
from .test_sortbench_trace import EVENTS

CELL = "zipf12_256Mi_1card.agg_count"
ALPHA = 1.2


def test_cell_correct_on_cpu():
    line = run_small(CELL)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 2
    assert line["compared"] == {name: {"value": 0, "limit": 0}
                                for name in ("wrong_groups", "wrong_counts", "overflow")}
    assert set(line["metrics"]) == {"keys_per_s", "setup_s"}  # no card: no peak memory
    json.dumps(line)


def test_cell_traced_on_cpu_opens_the_aggregate_spans():
    with spans.splitting() as found:
        line = run_small(CELL, traced=True, seconds=0.1)
    assert line["correct"] is True and line["metrics"] == {}  # the readers find no card
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    per_call = found[0]["spans_per_call"]
    assert {n: k for n, k in per_call.items() if n.startswith("grs.aggregate")} == {
        "grs.aggregate": 1, "grs.aggregate.hash_order": 1, "grs.aggregate.combine": 2,
        "grs.aggregate.splitters": 1, "grs.aggregate.exchange": 1, "grs.aggregate.merge": 1}
    assert per_call["grs.sort_full"] == 1


def test_control_fails_the_check():
    line = run_small(CELL, program=cells.load(CELL).entry.control)
    assert line["correct"] is False
    assert line["compared"]["wrong_groups"]["value"] + line["compared"]["wrong_counts"]["value"] > 0


def _group_dropped(out):
    keys, counts, ngroups, overflow = out
    return keys, counts, [ngroups[0] - 1], overflow


def _count_changed(out):
    keys, counts, ngroups, overflow = out
    c = counts[0].clone().view(torch.int32)
    c[0] += 1
    return keys, [c.view(counts[0].dtype)], ngroups, overflow


def _overflow_reported(out):
    keys, counts, ngroups, overflow = out
    return keys, counts, ngroups, overflow + 1


@pytest.mark.parametrize("fault,check", [(_group_dropped, "wrong_groups"),
                                         (_count_changed, "wrong_counts"),
                                         (_overflow_reported, "overflow"),
                                         (lambda out: out[0], "wrong_groups")])
def test_fault_fails_the_check(fault, check):
    def program(cell, devices):
        real = cell.entry.program(cell, devices)
        return lambda inputs: fault(real(inputs))

    line = run_small(CELL, program=program)
    assert line["correct"] is False and line["compared"][check]["value"] > 0


def test_rows_seeded():
    shard = make_keys(SEED, 1 << 16, "cpu")
    a = zipf.rows(shard, ALPHA)
    assert a.dtype == torch.uint32 and a.shape == shard.shape
    assert torch.equal(a, zipf.rows(shard.clone(), ALPHA))
    assert not torch.equal(a, zipf.rows(make_keys(SEED + 1, 1 << 16, "cpu"), ALPHA))


def test_rows_near_their_expectation():
    n = 1 << 20
    keys, rows = group_count(zipf.rows(make_keys(SEED, n, "cpu"), ALPHA))
    assert abs(keys.numel() / zipf.expected_groups(n, ALPHA) - 1) < 0.05
    assert abs(int(rows.max()) / n - 0.179) < 0.005  # 1 / zeta(1.2)


def test_config_states_the_makers_expectation():
    cell = cells.load(CELL)
    assert cell.keys_per_card == 1 << 28 and cell.chips == cell.config["cards"] == 1
    assert cell.config["zipf_alpha"] == ALPHA
    assert cell.config["groups_expected"] == round(zipf.expected_groups(1 << 28, ALPHA))
    work = next(w for w in cells.benchmark()["workloads"] if w["name"] == CELL)
    assert work["chips"] == 1


def test_ranks_spread_as_the_ports_keygen_spreads_them():
    from gpu_radix_sort_tpu_torch.utils.keygen import generate_zipf_keys

    ranks = np.random.default_rng(7).zipf(ALPHA, size=5000)
    got = zipf.fib_hash(torch.from_numpy(ranks.astype(np.int64)))
    want = generate_zipf_keys(5000, alpha=ALPHA, seed=7)
    assert got.tolist() == want.astype(np.int64).tolist()
    wide = torch.tensor([0, 1, 2**32 - 1, 2**32, 2**62 - 1])
    exact = [(r * zipf.FIB % 2**64) >> 32 for r in wide.tolist()]
    assert zipf.fib_hash(wide).tolist() == exact


def test_ranks_from_words():
    table, tail = zipf.cdf(ALPHA)
    first_tail = int(torch.ceil(table[-1] * 2**32 - 0.5))  # u = (w + 1/2) / 2^32
    words = torch.tensor([0, 2**31, 2**32 - 1, first_tail - 1, first_tail])
    got = zipf.ranks(words, table, tail, ALPHA).tolist()
    assert got[0] == 1 and 1 < got[1] < zipf.EXACT and got[2] == zipf.MAX_RANK
    assert got[3:] == [zipf.EXACT, zipf.EXACT + 1]


def test_reference_equals_the_ports():
    from gpu_radix_sort_tpu_torch.reference.group_count import group_count as port

    keys = zipf.rows(make_keys(SEED, 1 << 14, "cpu"), ALPHA)
    for got, want in zip(group_count(keys), port(keys)):
        assert torch.equal(got, want)


def test_maker_and_reference_load_nothing_of_the_port():
    done = subprocess.run(
        [sys.executable, "-c", "import sys, sortbench.zipf, sortbench.reference_group_count\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=cells.ROOT, capture_output=True, text=True, check=True, timeout=300)
    loaded = set(ast.literal_eval(done.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "gpu_radix_sort_tpu", "gpu_radix_sort_tpu_torch"}
    for name in ("zipf.py", "reference_group_count.py"):
        tree = ast.parse((cells.ROOT / "sortbench" / name).read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert names <= {"__future__", "torch"}, name


def test_readers_on_made_up_events():
    cell = cells.load(CELL)
    run = harness.Run(cell, "NVIDIA H100 80GB HBM3", 1.0, 0.04, 2,
                      call_ms=[20.0, 20.0], enqueue_ms=[10.0, 10.0],
                      bytes_per_card=2 * 10**9, trace=trace.reduce(EVENTS, [0, 1]))
    got = {m.name: cells.reader(cell, m).read(run) for m in cell.per_layer}
    assert got["agg_kernels_ms"] == pytest.approx(4.0)  # merge_level_kernel, card 0
    assert got["agg_torch_ms"] == pytest.approx(3.0)  # the peer copies, card 1
    assert got["agg_roofline"] == pytest.approx(100 * 2e9 / 3.35e12 / 0.006)
    run.trace = None
    assert all(cells.reader(cell, m).read(run) is None for m in cell.per_layer)


def test_bytes_per_card():
    cell = cells.load(CELL)
    assert cell.entry.bytes_per_card(cell) == 4 * 2**28 + 8 * cell.config["groups_expected"]
