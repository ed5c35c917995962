"""Run one cell of BENCHMARK.json and print its result as the last line.

    python3 -m sortbench.run --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of the checkout.  It needs CUDA and as many cards as the
cell names, and exits with 2 and prints no result where they are missing;
it exits with 3 and prints no result where jax, jaxlib, flax or the JAX
package was loaded.  The last lines of standard error, and the key
``compared`` that ends the result line, give every number the check
compared, each beside its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up starts here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "gpu_radix_sort_tpu"}


def forbidden_modules(names=None) -> list[str]:
    """Top-level names of the loaded modules (or of ``names``), compared
    whole, that the run may not hold."""
    return sorted({name.split(".")[0] for name in names or sys.modules} & FORBIDDEN)


def card_lines() -> str:
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return "; ".join(done.stdout.split("\n")).strip("; ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import cells, harness

    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        harness.log("no CUDA device: this benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} visible")
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    line = harness.run(cell, args.seed, args.seconds, bool(args.trace), devices, T0)
    found = forbidden_modules()
    if found:
        harness.log(f"the run loaded {found}: no result")
        return 3
    harness.log(f"cards: {card_lines()}")
    for name, c in line["compared"].items():
        harness.log(f"compared {name} {c['value']} limit {c['limit']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
