#!/usr/bin/env python3
"""Times the merge level (B2, merge_level_kernel in
gpu_radix_sort_tpu_torch/csrc/merge_path.cu) in other forms, on one CUDA
card.

    python3 tools/merge_variants.py

Builds a copy of merge_path.cu once for each form below (the shipped
source, patched by VARIANTS) in gpu_radix_sort_tpu_torch/_build/merge_variants/:

  shipped       512 threads x 16 keys (8192-key blocks), splits by a warp
                each (32 probes a step), 16-byte loads and stores
  blocks_4k     256 x 16: the block size of the first port
  blocks_16k    512 x 32
  threads_1024  1024 x 16
  items_15      512 x 15 (odd: a thread's merge reads spread over banks)
  items_17      512 x 17
  split_thread  one thread's binary search a split (the first port's)
  vector_1      4-byte loads and stores (heads of <= 3 keys as shipped)
  search_only   the shipped splits, then nothing else (one word a block
                written): the search's own cost, for timing only

prints what ptxas says of each, holds each but search_only against the
plain version byte for byte (L from 1 to 2^25, input 0-3 keys past a
16-byte boundary), then prints, twice in turn, the CUDA-event median of one
level of 64M keys at L = 2^14 and at L = 2^25 (the top level), beside copy_
of the same bytes and torch.sort of the (n / 2L, 2L) rows, each form
through its C entry point.  Needs nvcc and a card.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpu_radix_sort_tpu_torch.kernels import build  # noqa: E402
from gpu_radix_sort_tpu_torch.ops import block_sort as bs  # noqa: E402
from gpu_radix_sort_tpu_torch.ops import merge_sort as ms  # noqa: E402
from gpu_radix_sort_tpu_torch.utils import timers  # noqa: E402
from network_variants import build_variants, card_line  # noqa: E402

N = 1 << 26
SRC = "merge_path.cu"
THREADS, ITEMS = "constexpr int kThreads = 512;", "constexpr int kItems = 16;"
SPLIT_THREAD = """// One thread's binary search for split_warp's answer.
__device__ long long split_thread(const uint32_t* x, const Pair& q, long long diag) {
  long long lo = max(0LL, diag - q.lb), hi = min(diag, q.la);
  const uint32_t* a = x + q.base;
  const uint32_t* b = x + q.end() - diag;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= b[mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

"""
KERNEL = "__global__ void __launch_bounds__(kThreads)\nmerge_level_kernel("
WARP_SPLITS = """  if (threadIdx.x < 64) {
    const int w = threadIdx.x >> 5;
    const long long a = split_warp(x, q, w ? k1 : k0);
    if ((threadIdx.x & 31) == 0) split[w] = a;
  }
"""
THREAD_SPLITS = "  if (threadIdx.x < 2) split[threadIdx.x] = split_thread(x, q, threadIdx.x ? k1 : k0);\n"
FIRST_SPLIT = "  const long long a0 = split[0];\n"
VARIANTS = {
    "shipped": [],
    "blocks_4k": [(SRC, THREADS, "constexpr int kThreads = 256;")],
    "blocks_16k": [(SRC, ITEMS, "constexpr int kItems = 32;")],
    "threads_1024": [(SRC, THREADS, "constexpr int kThreads = 1024;")],
    "items_15": [(SRC, ITEMS, "constexpr int kItems = 15;")],
    "items_17": [(SRC, ITEMS, "constexpr int kItems = 17;")],
    "split_thread": [(SRC, KERNEL, SPLIT_THREAD + KERNEL),
                     (SRC, WARP_SPLITS, THREAD_SPLITS)],
    "vector_1": [(SRC, "constexpr int kVec = 4;", "constexpr int kVec = 1;"),
                 (SRC, "using Vec = uint4;", "using Vec = uint32_t;"),
                 (SRC, "return make_uint4(k[0], k[1], k[2], k[3]);", "return k[0];")],
    "search_only": [(SRC, FIRST_SPLIT, FIRST_SPLIT + "  if (threadIdx.x == 0) "
                     "out[blockIdx.x] = (uint32_t)(split[1] - a0);\n  return;\n")],
}
TIMING_ONLY = {"search_only"}


def main() -> int:
    if not torch.cuda.is_available():
        print("merge_variants: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    root = build.BUILD_DIR / "merge_variants"
    libs = build_variants(root, SRC, VARIANTS, ("grs_merge_level_u32",),
                          "18merge_level_kernel")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)

    def level(lib, x, L, out) -> None:
        status = lib.grs_merge_level_u32(x.data_ptr(), out.data_ptr(), x.numel(), L,
                                         torch.cuda.current_stream().cuda_stream)
        if status:
            raise SystemExit(f"merge_variants: CUDA error {status}")

    for n, L in ((1001, 1), (997, 3), (5000, 128), (20011, 1000), (100003, 4099),
                 (N, 1 << 14), (N, N // 2)):
        for kind in ("random", "ties"):
            a = (rng.integers(0, 1 << 32, n, dtype=np.uint32) if kind == "random"
                 else rng.integers(0, 3, n, dtype=np.uint32))
            runs = bs.sort_runs_plain(torch.from_numpy(a).to(dev), L, alternate=True)
            want = ms.merge_level_plain(runs, L)
            for shift in (0, 1, 2, 3) if n < N else (0,):
                x = torch.empty(n + 4, dtype=torch.uint32, device=dev)[shift:shift + n]
                x.copy_(runs)
                for name, lib in libs.items():
                    if name in TIMING_ONLY:
                        continue
                    out = torch.empty_like(x)
                    level(lib, x, L, out)
                    torch.cuda.synchronize()
                    if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                        raise SystemExit(f"merge_variants: {name} differs from the plain "
                                         f"version at n={n} L={L} {kind} shift={shift}")
    del runs, want, x, out
    print("every variant but search_only equal to the plain version byte for byte",
          flush=True)

    keys = torch.from_numpy(rng.integers(0, 1 << 32, N, dtype=np.uint32)).to(dev)
    inputs = {L: bs.sort_runs_plain(keys, L, alternate=True) for L in (1 << 14, N // 2)}
    out = torch.empty_like(keys)
    pairs = inputs[1 << 14].view(torch.int32).view(-1, 1 << 15)
    for turn in range(2):
        ms_copy = timers.time_cuda(lambda: out.copy_(keys))
        ms_lib = timers.time_cuda(lambda: torch.sort(pairs, dim=1))
        print(f"turn {turn} [{card}]: copy_ of {N} keys {ms_copy:.4f} ms; torch.sort of "
              f"the (n/2L, 2L) rows at L=2^14 {ms_lib:.4f} ms", flush=True)
        for name, lib in (libs.items() if turn == 0 else reversed(libs.items())):
            line = ", ".join(
                f"L={L} {timers.time_cuda(lambda: level(lib, x, L, out)):.4f} ms"
                for L, x in inputs.items())
            print(f"turn {turn} {name:13s} [{card}]: {line}", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
