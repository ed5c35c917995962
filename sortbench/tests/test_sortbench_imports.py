"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package,
and the reference loads nothing of the port.  Top-level module names, the
part before the first dot, are compared whole: the port's name begins
with the JAX package's."""

import ast
import subprocess
import sys

from sortbench import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "gpu_radix_sort_tpu"}

_RUN_EVERY_CELL = """
import sys, time, torch
from sortbench import cells, control, harness, run, sets
bench = cells.benchmark()
for w in bench["workloads"]:
    cell = cells.load(w["name"], keys_per_card=4096)
    devices = [torch.device("cpu")] * cell.chips
    for traced in (False, True):
        line = harness.run(cell, 5, 0.05, traced, devices, time.perf_counter())
        assert line["correct"], line
    for m in cell.end_to_end + cell.per_layer:
        cells.reader(cell, m)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def _fresh(code: str) -> set[str]:
    done = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                          capture_output=True, text=True, check=True, timeout=600)
    return set(ast.literal_eval(done.stdout.strip().splitlines()[-1]))


def test_every_cell_loads_no_jax():
    loaded = _fresh(_RUN_EVERY_CELL)
    assert "gpu_radix_sort_tpu_torch" in loaded  # the port did run
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    loaded = _fresh("import sys, sortbench.reference, sortbench.keys, sortbench.stats\n"
                    "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert not loaded & (FORBIDDEN | {"gpu_radix_sort_tpu_torch"})
    tree = ast.parse((cells.ROOT / "sortbench" / "reference.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert names <= {"__future__", "numpy", "torch"}


def test_run_checks_loaded_modules():
    from sortbench import run

    assert run.forbidden_modules(["gpu_radix_sort_tpu_torch.ops", "jaxtyping", "torch"]) == []
    assert run.forbidden_modules(["jax.numpy", "flax", "gpu_radix_sort_tpu.ops"]) == [
        "flax", "gpu_radix_sort_tpu", "jax"]
