"""A configuration, a traffic mix and a metric added as new files, with no
edit to a file that is there, are found by name and run."""

import json
import shutil

from sortbench import cells

from .helpers import run_small


def test_new_files_are_found(tmp_path):
    shutil.copytree(cells.ROOT / "sortbench", tmp_path / "sortbench")
    bench = cells.benchmark()
    base = tmp_path / "sortbench"
    (base / "configs" / "u32_8Ki_cpu.json").write_text(json.dumps(
        {"name": "u32_8Ki_cpu", "cards": 1, "keys_per_card": 8192,
         "source": "a test", "reduced": []}))
    (base / "traffic" / "partial_w4.json").write_text(json.dumps(
        {"entry": "sort_partial", "params": {"offset": 4, "width": 4, "stable": True}}))
    (base / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return len(run.call_ms)\n")
    bench["workloads"].append({"name": "u32_8Ki_cpu.partial_w4", "config": "u32_8Ki_cpu",
                               "traffic": "partial_w4", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "calls_in_window", "unit": "count",
                                "better": "higher", "bound": 0.01, "source": "host_clock",
                                "workloads": ["u32_8Ki_cpu.partial_w4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load("u32_8Ki_cpu.partial_w4", tmp_path)
    assert cell.keys_per_card == 8192 and cell.params["width"] == 4
    assert [m.name for m in cell.end_to_end][-1] == "calls_in_window"
    line = run_small("u32_8Ki_cpu.partial_w4", root=tmp_path, keys_per_card=8192)
    assert line["correct"] is True
    assert line["metrics"]["calls_in_window"]["value"] == line["attempted"]
    assert "u32_8Ki_cpu" not in {w["config"] for w in cells.benchmark()["workloads"]}


def test_metric_reading_nothing_is_left_out(tmp_path):
    shutil.copytree(cells.ROOT / "sortbench", tmp_path / "sortbench")
    bench = cells.benchmark()
    (tmp_path / "sortbench" / "metrics" / "nothing.py").write_text(
        "def read(run):\n    return None\n")
    bench["end_to_end"].append({"name": "nothing", "unit": "ms", "better": "lower",
                                "bound": 0.01, "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    line = run_small("u32_256Mi_1card.full", root=tmp_path)
    assert "nothing" not in line["metrics"] and "keys_per_s" in line["metrics"]
