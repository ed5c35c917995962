"""On a card: each cell's entry through the harness at 2^22 keys a card,
against the reference, and its control found not correct."""

import pytest

from sortbench import cells

from .helpers import CELLS, run_small

SIZE = 1 << 22


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_card(name, cuda_devices):
    cell = cells.load(name)
    if len(cuda_devices) < cell.chips:
        pytest.skip(f"{name} needs {cell.chips} cards")
    devices = cuda_devices[:cell.chips]
    line = run_small(name, devices=devices, keys_per_card=SIZE, seconds=1)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert "peak_mem_gib" in line["metrics"]
    traced = run_small(name, devices=devices, keys_per_card=SIZE, seconds=1, traced=True)
    assert traced["correct"] is True and traced["device"]["busy_s"] > 0
    assert {"launches_per_call", "torch_ops_pct", "device_idle_pct"} <= set(traced["metrics"])
    control = run_small(name, devices=devices, keys_per_card=SIZE, seconds=1,
                        program=cell.entry.control)
    assert control["correct"] is False
