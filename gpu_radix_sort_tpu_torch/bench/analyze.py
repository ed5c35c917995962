"""Benchmark record analysis: cost stacks and run-to-run comparison.

Port of ``gpu_radix_sort_tpu/bench/analyze.py`` (pure Python, the same
text).  Reference analog: the analysis/ notebook that joins nvprof +
cProfile CSVs into per-phase cost stacks (SURVEY.md §5).  Operates on the
JSON-lines output of ``python -m gpu_radix_sort_tpu_torch bench --json``
(BenchRecord dicts).

Usage:
    python -m gpu_radix_sort_tpu_torch analyze run1.jsonl [run2.jsonl]

With one file: a table plus per-phase breakdowns for records that carry
storage-path SortStats.  With two: side-by-side rates and speedups
(run2 vs run1).
"""

from __future__ import annotations

import json
import sys


def load_records(path: str) -> list[dict]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def _fmt_rate(rec: dict) -> str:
    return f"{rec['rate_per_s'] / 1e6:9.1f}M {rec['unit']}"


def report_single(records: list[dict]) -> str:
    out = []
    for r in records:
        out.append(
            f"{r['name']:<34} n={r['n']:>12,} "
            f"median={r['median_s'] * 1e3:9.2f}ms {_fmt_rate(r)}"
        )
        phases = r.get("extra", {}).get("phases")
        if phases:
            total = sum(
                v["total_s"] for k, v in phases.items()
                if isinstance(v, dict)
            )
            for k, v in sorted(
                (kv for kv in phases.items() if isinstance(kv[1], dict)),
                key=lambda kv: -kv[1]["total_s"],
            ):
                pct = 100 * v["total_s"] / total if total else 0
                out.append(
                    f"    {k:<22} {v['total_s'] * 1e3:9.2f}ms "
                    f"({pct:5.1f}%)  n={v['n']}"
                )
    return "\n".join(out)


def report_compare(base: list[dict], new: list[dict]) -> str:
    by_name = {r["name"]: r for r in base}
    out = [f"{'benchmark':<34} {'base':>12} {'new':>12} {'speedup':>8}"]
    for r in new:
        b = by_name.get(r["name"])
        if b is None:
            out.append(f"{r['name']:<34} {'—':>12} {_fmt_rate(r):>12}")
            continue
        speed = (
            r["rate_per_s"] / b["rate_per_s"] if b["rate_per_s"] else float("inf")
        )
        out.append(
            f"{r['name']:<34} {b['rate_per_s'] / 1e6:>11.1f}M "
            f"{r['rate_per_s'] / 1e6:>11.1f}M {speed:>7.2f}x"
        )
    # benchmarks present only in the base run: a run that LOSES a
    # benchmark (crash, removal) must not read as a clean comparison.
    new_names = {r["name"] for r in new}
    for r in base:
        if r["name"] not in new_names:
            out.append(f"{r['name']:<34} {_fmt_rate(r):>12} {'—':>12}")
    return "\n".join(out)


def main(argv: list[str]) -> int:
    if not argv or len(argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    if len(argv) == 1:
        print(report_single(load_records(argv[0])))
    else:
        print(report_compare(load_records(argv[0]), load_records(argv[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
