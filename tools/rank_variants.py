#!/usr/bin/env python3
"""Times variants of the counting-sort ranking of
gpu_radix_sort_tpu_torch/csrc/block_rank.cuh on one CUDA card.

    python3 tools/rank_variants.py

Builds block_sort.cu and exchange.cu five times into
gpu_radix_sort_tpu_torch/_build/rank_variants/, each with another form of
block_rank.cuh:

  committed     count: a shared atomic a key; place: 8 ballots for the
                peers, the lowest peer's load and store of the counter, a
                shuffle of the counter, a __syncwarp
  width-ballots ballots only for the digit's bits
  atomic-place  the lowest peer's atomic add in place of its load and
                store, and no __syncwarp
  run-count     ballot peers in the count too, one add a run of peers
  match-place   __match_any_sync for the peers of the place

holds each against the plain versions byte for byte, then prints, twice in
turn, the CUDA-event median of one B7 sort-only round (4 launches of 64Mi
uniform keys, tile 2^14, width 8), of one 64Mi launch of skewed and of
all-equal keys, and of B4 at 2^14 keys by 8 and 17 bits, each through the C
entry point (no Python wrapper).  Needs nvcc and a card.
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

from gpu_radix_sort_tpu_torch.kernels import build  # noqa: E402
from gpu_radix_sort_tpu_torch.ops import digit_sort as ds  # noqa: E402
from gpu_radix_sort_tpu_torch.parallel import rdma_overlap as ov  # noqa: E402
from gpu_radix_sort_tpu_torch.utils import timers  # noqa: E402

PEERS = "__device__ __forceinline__ unsigned warp_peers(uint32_t digit) {\n"
COUNT = "    if (k < K) atomicAdd(&cnt[((keys[k] >> shift) & mask) * 33 + warp], 1u);\n"
RUN_COUNT = """    if (k < K) {
      const uint32_t d = (keys[k] >> shift) & mask;
      const unsigned peers = warp_peers(d);
      if ((peers & below) == 0) atomicAdd(&cnt[d * 33 + warp], (uint32_t)__popc(peers));
    }
"""
MATCH = PEERS + "  return __match_any_sync(0xFFFFFFFFu, digit);\n"
PLACE = """      if (lane == leader) {
        base = cnt[d * 33 + warp];
        cnt[d * 33 + warp] = base + __popc(peers);
      }
      base = __shfl_sync(0xFFFFFFFFu, base, leader);
      out[base + __popc(peers & below)] = keys[k];
      __syncwarp();  // this k's counters before the next k reads them
"""
ATOMIC = """      if (lane == leader) base = atomicAdd(&cnt[d * 33 + warp], (uint32_t)__popc(peers));
      base = __shfl_sync(0xFFFFFFFFu, base, leader);
      out[base + __popc(peers & below)] = keys[k];
"""
BITS = "  for (int b = 0; b < kMaxRankWidth; ++b) {\n"


def width_ballots(text: str) -> str:
    return (text.replace("warp_peers(uint32_t digit)", "warp_peers(uint32_t digit, int width)")
            .replace(BITS, BITS + "    if (b >= width) break;\n")
            .replace("warp_peers(d)", "warp_peers(d, width)"))


def variants(text: str) -> dict[str, str]:
    assert all(m in text for m in (PEERS, COUNT, PLACE, BITS)), \
        "block_rank.cuh changed: update the variants"
    return {"committed": text, "width-ballots": width_ballots(text),
            "atomic-place": text.replace(PLACE, ATOMIC),
            "run-count": text.replace(COUNT, RUN_COUNT),
            "match-place": text.replace(PEERS, MATCH)}


def build_variants(root: Path) -> dict[str, ctypes.CDLL]:
    shutil.rmtree(root, ignore_errors=True)
    nvcc = build._nvcc()
    texts = variants((build.CSRC / "block_rank.cuh").read_text())
    procs = []
    for name, text in texts.items():
        d = root / name
        d.mkdir(parents=True)
        for f in ("block_sort.cu", "exchange.cu", "register_bitonic.cuh"):
            shutil.copy(build.CSRC / f, d / f)
        (d / "block_rank.cuh").write_text(text)
        for f in ("block_sort", "exchange"):
            procs.append(subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-c", "-o", str(d / f"{f}.o"), str(d / f"{f}.cu")],
                stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(err)
    libs = {}
    for name in texts:
        d = root / name
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
                        str(d / "block_sort.o"), str(d / "exchange.o")], check=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn, sig in build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = sig
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("rank_variants: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    libs = build_variants(build.BUILD_DIR / "rank_variants")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    P, n_rank, tile = 4, 1 << 26, 1 << 14
    shards = [torch.from_numpy(rng.integers(0, 1 << 32, n_rank, dtype=np.uint32)).to(dev)
              for _ in range(P)]
    skew = torch.from_numpy((rng.zipf(1.3, n_rank) % (1 << 16)).astype(np.uint32)
                            << np.uint32(8)).to(dev)
    equal = torch.full((n_rank,), 0x1234, dtype=torch.int32, device=dev).view(torch.uint32)
    stages = [torch.empty_like(s) for s in shards]
    small = shards[0][:ds.MAX_N_KV].clone()
    small_out = torch.empty_like(small)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def group_sort(lib, xs, outs, offset=0):
        for x, o in zip(xs, outs):
            build.check(lib.grs_group_sort_send_u32(x.data_ptr(), x.numel(), tile, offset, 8,
                                                    None, 0, None, o.data_ptr(), stream()),
                        "group_sort")

    def digit_sort(lib, width):
        build.check(lib.grs_digit_sort_u32(small.data_ptr(), small_out.data_ptr(),
                                           small.numel(), 0, width, stream()), "digit_sort")

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    for name, lib in libs.items():
        for x, o, offset in ((shards[0], stages[0], 0), (skew, stages[1], 8), (equal, stages[2], 0)):
            group_sort(lib, [x], [o], offset)
            torch.cuda.synchronize()
            if not same(o, ov.sort_groups_plain(x, tile, offset, 8)):
                raise SystemExit(f"rank_variants: {name} group sort differs from the plain version")
        for w in (8, 17):
            digit_sort(lib, w)
            torch.cuda.synchronize()
            if not same(small_out, ds.sort_by_digits_small_plain(small, 0, w)):
                raise SystemExit(f"rank_variants: {name} digit sort differs from the plain version")
    print("every variant equal to the plain versions byte for byte", flush=True)

    for turn in range(2):
        for name, lib in libs.items():
            t_round = timers.time_cuda(lambda: group_sort(lib, shards, stages))
            t_skew = timers.time_cuda(lambda: group_sort(lib, [skew], stages[:1], 8))
            t_equal = timers.time_cuda(lambda: group_sort(lib, [equal], stages[:1]))
            t_w8 = timers.time_cuda(lambda: digit_sort(lib, 8), iters=50)
            t_w17 = timers.time_cuda(lambda: digit_sort(lib, 17), iters=50)
            print(f"turn {turn} {name:12s} [{card}]: B7 sort-only round 4x64Mi "
                  f"{t_round:.3f} ms; one 64Mi launch, skewed {t_skew:.3f} ms, all-equal "
                  f"{t_equal:.3f} ms; B4 2^14 keys w8 {t_w8:.4f} ms, w17 {t_w17:.4f} ms",
                  flush=True)
    shutil.rmtree(build.BUILD_DIR / "rank_variants", ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
