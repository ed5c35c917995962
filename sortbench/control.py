"""Run a cell's control on the cards, on several seeds, in one process.

    python3 -m sortbench.control --workload <cell> --seeds 11,12,13 [--seconds 2]

The control is the entry's ``control``: the reference one step below what
the configuration states, or the port's own route that drops a guarantee,
put in the program's place for a short window at the cell's size.  The
check has to find it not correct on every seed; each seed's compared
numbers are printed beside their limits, and the exit code is 0 only where
every seed came out not correct.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from . import cells, harness

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA cards")
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    caught = True
    for seed in (int(s) for s in args.seeds.split(",")):
        line = harness.run(cell, seed, args.seconds, False, devices,
                           time.perf_counter(), program=cell.entry.control)
        caught = caught and not line["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": line["correct"], "compared": line["compared"]}),
              flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
