"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

A cell ``<config>.<traffic>`` is one entry of ``workloads``: its
configuration is ``sortbench/configs/<config>.json``, its traffic
``sortbench/traffic/<traffic>.json``, which names an entry
``sortbench/entries/<entry>.py``, and each metric is read by
``sortbench/metrics/<metric>.py``.  Modules are loaded from their files,
so a name may hold dots and a later change adds a piece as a new file.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent.parent  # the checkout


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    entry: ModuleType
    end_to_end: list[Metric]
    per_layer: list[Metric]
    root: Path = ROOT
    params: dict = field(default_factory=dict)

    @property
    def keys_per_card(self) -> int:
        return int(self.config["keys_per_card"])

    def metrics(self, trace: bool) -> list[Metric]:
        return self.per_layer if trace else self.end_to_end


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> dict:
    return _read_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT, **params) -> Cell:
    """The cell named ``name`` in ``root``'s BENCHMARK.json; ``params``
    override its traffic's parameters (the tests use this for small
    sizes on the CPU, with ``keys_per_card``)."""
    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    work = found[0]
    base = root / "sortbench"
    config = _read_json(base / "configs" / f"{work['config']}.json")
    if "keys_per_card" in params:
        config = {**config, "keys_per_card": params.pop("keys_per_card")}
    traffic = _read_json(base / "traffic" / f"{work['traffic']}.json")
    entry = _load_module(base / "entries" / f"{traffic['entry']}.py",
                         f"sortbench_entry_{traffic['entry']}")
    return Cell(
        name=name,
        chips=int(work["chips"]),
        config=config,
        entry=entry,
        end_to_end=[Metric(m["name"], m["unit"])
                    for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[Metric(m["name"], m["unit"])
                   for m in bench["per_layer"] if _applies(m, name)],
        root=root,
        params={**traffic.get("params", {}), **params},
    )


def reader(cell: Cell, metric: Metric) -> ModuleType:
    """The module whose ``read(run)`` gives the metric."""
    return _load_module(cell.root / "sortbench" / "metrics" / f"{metric.name}.py",
                        f"sortbench_metric_{metric.name.replace('.', '_')}")
