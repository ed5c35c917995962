#!/usr/bin/env python3
"""Times the one-block sort's register network (B3, single_block_sort_kernel
in gpu_radix_sort_tpu_torch/csrc/block_sort.cu, register_bitonic.cuh) at
other numbers of keys a thread, on one CUDA card.

    python3 tools/network_variants.py

Builds block_sort.cu once for each kSingleRegLog below into
gpu_radix_sort_tpu_torch/_build/network_variants/:

  r4   16 keys a thread (1024 threads at 2^14 keys): 40 shuffle and 15
       shared-memory stages of 105
  r5   32 keys a thread (512 threads): 35 and 10
  r6   64 keys a thread (256 threads): 30 and 6

prints what ptxas says of the 2^14-key kernel, holds each against the plain
version byte for byte (n from 1 to 2^14, random and duplicate keys), then
prints, twice in turn, the device time of one call (a CUDA graph of 20
calls, median of 10) at 2^14, 4096 and 1000 keys, beside torch.sort of the
pre-flipped int32 keys, each through the C entry point.  Needs nvcc and a
card.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import graph_ms  # noqa: E402
from gpu_radix_sort_tpu_torch.kernels import build  # noqa: E402
from gpu_radix_sort_tpu_torch.ops import single_block as sb  # noqa: E402
from gpu_radix_sort_tpu_torch.ops.bits import sortable_digits  # noqa: E402

MARKER = "constexpr int kSingleRegLog = {}"
VARIANTS = {"r4": 4, "r5": 5, "r6": 6}
SIZES = (1 << 14, 4096, 1000)


def build_variants(root: Path) -> dict[str, ctypes.CDLL]:
    shutil.rmtree(root, ignore_errors=True)
    nvcc = build._nvcc()
    text = (build.CSRC / "block_sort.cu").read_text()
    committed = MARKER.format(sb.REG_LOG)
    assert committed in text, "block_sort.cu changed: update the marker"
    procs = {}
    for name, reg_log in VARIANTS.items():
        d = root / name
        d.mkdir(parents=True)
        for header in build._headers():
            shutil.copy(header, d / header.name)
        (d / "block_sort.cu").write_text(text.replace(committed, MARKER.format(reg_log)))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(d / "lib.so"),
             str(d / "block_sort.cu")], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(err)
        entry, report = False, []
        for line in err.splitlines():
            if "Compiling entry function" in line:
                entry = "single_block_sort_kernelILi14E" in line
            elif entry and ("Used" in line or "spill" in line):
                report.append(line.split(" : ", 1)[-1].strip())
        print(f"ptxas [{name}]: single_block_sort_kernel<14> {'; '.join(report)}", flush=True)
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        fn = lib.grs_single_block_sort_u32
        fn.argtypes = build._SIGNATURES["grs_single_block_sort_u32"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("network_variants: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    libs = build_variants(build.BUILD_DIR / "network_variants")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)

    def sort(lib, x, out) -> None:
        status = lib.grs_single_block_sort_u32(x.data_ptr(), out.data_ptr(), x.numel(),
                                               torch.cuda.current_stream().cuda_stream)
        if status:
            raise SystemExit(f"network_variants: CUDA error {status}")

    for name, lib in libs.items():
        for n in (1, 31, 512, 1000, 2048, 4099, 8192, (1 << 14) - 1, 1 << 14):
            for a in (rng.integers(0, 1 << 32, n, dtype=np.uint32),
                      np.array([0, 7, 0xFFFFFFFF], np.uint32)[rng.integers(0, 3, n)]):
                x = torch.from_numpy(a).to(dev)
                out = torch.empty_like(x)
                sort(lib, x, out)
                torch.cuda.synchronize()
                if not torch.equal(out.view(torch.int32),
                                   sb.sort_single_block_plain(x).view(torch.int32)):
                    raise SystemExit(f"network_variants: {name} differs from the plain "
                                     f"version at n={n}")
    print("every variant equal to the plain version byte for byte", flush=True)

    keys = {n: torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint32)).to(dev)
            for n in SIZES}
    outs = {n: torch.empty_like(x) for n, x in keys.items()}
    flipped = {n: sortable_digits(x, 0, 32) for n, x in keys.items()}
    for turn in range(2):
        line = ", ".join(f"{n} keys {graph_ms(lambda: torch.sort(flipped[n])):.4f} ms"
                         for n in SIZES)
        print(f"turn {turn} torch.sort [{card}]: {line}", flush=True)
        for name, lib in libs.items():
            line = ", ".join(
                f"{n} keys {graph_ms(lambda: sort(lib, keys[n], outs[n])):.4f} ms"
                for n in SIZES)
            print(f"turn {turn} {name:10s} [{card}]: {line}", flush=True)
    shutil.rmtree(build.BUILD_DIR / "network_variants", ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
