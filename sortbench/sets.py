"""Run one cell several times, one process a run, and summarise the set.

    python3 -m sortbench.sets --workload <cell> --seeds 1,2,3 --label A \\
        [--seconds S] [--trace 0] [--out sortbench_sets]

Each run is ``python3 -m sortbench.run`` with its own seed; its standard
output and error go to ``<out>/<cell>.<label>.<seed>.out|err`` and its
result line to ``<out>/<cell>.<label>.jsonl``; ``--seconds`` defaults to
BENCHMARK.json's ``run_seconds``.  The summary gives, for each
metric, the values, the median and the spread: the distance between the
quartiles (``statistics.quantiles(values, n=4)``) as a share of the median,
from which the bounds of BENCHMARK.json are set.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from . import cells
from .stats import spread


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--label", default="A")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default="sortbench_sets")
    args = ap.parse_args(argv)
    if args.seconds is None:
        args.seconds = cells.benchmark()["run_seconds"]

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    stem = f"{args.workload}.{args.label}"
    values: dict[str, list[float]] = {}
    bad = 0
    with open(out / f"{stem}.jsonl", "a") as lines:
        for seed in args.seeds.split(","):
            cmd = [sys.executable, "-m", "sortbench.run", "--workload", args.workload,
                   "--seed", seed, "--seconds", str(args.seconds), "--trace", str(args.trace)]
            t = time.perf_counter()
            done = subprocess.run(cmd, capture_output=True, text=True, check=False)
            wall = time.perf_counter() - t
            (out / f"{stem}.{seed}.out").write_text(done.stdout)
            (out / f"{stem}.{seed}.err").write_text(done.stderr)
            try:
                line = json.loads(done.stdout.strip().splitlines()[-1])
            except (IndexError, json.JSONDecodeError):
                bad += 1
                print(f"{stem} seed {seed} rc {done.returncode} wall {wall:.1f} s: no result\n"
                      f"{done.stderr[-3000:]}", flush=True)
                continue
            lines.write(json.dumps({"seed": seed, "rc": done.returncode, "wall_s": wall,
                                    **line}) + "\n")
            bad += not line["correct"]
            got = {k: m["value"] for k, m in line["metrics"].items()}
            for k, v in got.items():
                values.setdefault(k, []).append(v)
            tail = [s for s in done.stderr.splitlines() if s.startswith(("set-up", "window", "calls"))]
            print(f"{stem} seed {seed} rc {done.returncode} wall {wall:.1f} s "
                  f"correct {line['correct']} attempted {line['attempted']} "
                  f"peak {line['device']['memory_peak_bytes']} {json.dumps(got)}\n    "
                  + "\n    ".join(tail), flush=True)
            if args.trace:
                print(f"    device {json.dumps(line['device'])}\n    "
                      f"breakdown {json.dumps(line.get('breakdown'))}", flush=True)
    for k, vs in values.items():
        med = statistics.median(vs)
        sp = spread(vs) if len(vs) >= 2 and med else float("nan")
        print(f"SUMMARY {stem} {k} n {len(vs)} median {med} spread {sp:.5f} values {vs}",
              flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
