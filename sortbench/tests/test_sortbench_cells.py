"""Each cell's entry through the harness at a small size, against the
reference; the result line's shape; the CLI's refusals."""

import json

import pytest
import torch

from sortbench import cells, reference, run, stats
from sortbench.keys import make_keys, stream_seed

from .helpers import CELLS, SEED, run_small


@pytest.mark.parametrize("name", CELLS)
def test_cell_correct_on_cpu(name):
    line = run_small(name)
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] >= 2
    assert all(c["value"] == 0 for c in line["compared"].values())
    assert list(line)[-1] == "compared"
    want = {"keys_per_s", "setup_s"} | ({"call_ms_p95"} if "1card" in name else set())
    assert set(line["metrics"]) == want  # peak memory reads nothing on the CPU
    assert line["device"]["count"] == cells.load(name).chips
    json.dumps(line)


@pytest.mark.parametrize("name", CELLS)
def test_cell_traced_on_cpu(name):
    line = run_small(name, traced=True)
    assert line["correct"] is True
    want = {"host_call_ms"} | ({"call_ms_p95.mesh"} if "4card" in name else set())
    assert set(line["metrics"]) == want  # the device-trace readers find no card
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_mesh_alltoall_route_on_cpu():
    """The cell's exchange is "auto", which is "gather" at a test's size and
    "alltoall" at the cell's: drive "alltoall" too."""
    line = run_small("u32_1Gi_4card.lsd_w8", exchange="alltoall", keys_per_card=1 << 14)
    assert line["correct"] is True
    assert line["compared"]["overflow"]["value"] == 0


def test_cells_from_benchmark_json():
    bench = cells.benchmark()
    assert [w["name"] for w in bench["workloads"]] == CELLS
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        assert cell.keys_per_card == 1 << 28
        assert cell.chips == cell.config["cards"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.reader(cell, m).read)
    names = {m["name"] for m in bench["end_to_end"]}
    assert names == {"keys_per_s", "call_ms_p95", "peak_mem_gib", "setup_s"}
    p95 = next(m for m in bench["end_to_end"] if m["name"] == "call_ms_p95")
    assert "u32_1Gi_4card.lsd_w8" not in p95["workloads"]


def test_keys_seeded_and_uniform():
    a = make_keys(SEED, 1 << 16, "cpu")
    assert torch.equal(a, make_keys(SEED, 1 << 16, "cpu"))
    assert not torch.equal(a, make_keys(SEED + 1, 1 << 16, "cpu"))
    assert not torch.equal(a, make_keys(SEED, 1 << 16, "cpu", stream=1))
    x = a.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert x.min() < 1 << 20 and x.max() > (1 << 32) - (1 << 20)
    assert stream_seed(-5, 0) != stream_seed(5, 0) and stream_seed(2**70, 3) < 2**63


def test_reference_sorts():
    keys = make_keys(SEED, 5000, "cpu")
    x = keys.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(reference.sort_full(keys).view(torch.int32).to(torch.int64) & 0xFFFFFFFF,
                       torch.sort(x).values)
    got, counts = reference.sort_by_digit(keys, 4, 8)
    d = (x >> 4) & 255
    order = torch.sort(d, stable=True).indices
    assert torch.equal(got.view(torch.int32), keys.view(torch.int32)[order])
    assert torch.equal(counts, torch.bincount(d, minlength=256))
    many = make_keys(SEED, 1 << 20, "cpu")  # keys 256 apart or nearer share a float32
    assert reference.mismatches(reference.sort_full_float32(many),
                                reference.sort_full(many)) > 1000


def _gpu_groups_boundaries(digits_sorted, nb):
    """The upstream's two steps on a sorted digit array, literally."""
    b = [0] * nb
    for i in range(1, len(digits_sorted)):
        if digits_sorted[i] != digits_sorted[i - 1]:
            b[digits_sorted[i]] = i
    for g in range(nb - 1, 1, -1):
        if b[g] == 0:
            b[g] = b[g + 1] if g + 1 < nb else len(digits_sorted)
    return b


@pytest.mark.parametrize("digits", [
    [0, 0, 1, 3, 3, 7], [1, 1, 2, 5], [2, 2, 2, 6], [3, 5, 5], [7, 7], [0, 4, 7], [1, 7],
])
def test_reference_boundaries_quirks(digits):
    nb = 8
    counts = torch.bincount(torch.tensor(digits), minlength=nb).numpy()
    assert list(reference.boundaries(counts, len(digits))) == _gpu_groups_boundaries(digits, nb)


def test_reference_boundaries_match_port():
    from gpu_radix_sort_tpu_torch.ops.boundaries import compute_boundaries

    for seed in range(6):
        keys = make_keys(seed, 3000, "cpu")
        if seed % 2:  # leave groups 0 and 1 empty, as the quirks need
            keys = (keys.view(torch.int32) | 0x600).view(torch.uint32)
        got, counts = reference.sort_by_digit(keys, 8, 4)
        port = compute_boundaries(got, 8, 4).view(torch.int32).to(torch.int64)
        assert port.tolist() == list(reference.boundaries(counts.numpy(), 3000))


def test_stats():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile(list(range(101)), 95) == 95
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.spread([10, 10, 10, 10]) == 0


def test_cli_refuses_without_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert run.main(["--workload", CELLS[2], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
