#!/usr/bin/env python3
"""Times geometries of segment_copy_kernel (B6,
gpu_radix_sort_tpu_torch/csrc/exchange.cu) on one CUDA card.

    python3 tools/copy_variants.py

Builds exchange.cu once for each variant below into
gpu_radix_sort_tpu_torch/_build/copy_variants/, with other values of its
geometry constants (threads a block, source keys a block sends, vectors a
thread loads before it stores them, interleaved stripes of chunks):

  512-16k-u4-s16   the committed geometry
  512-16k-u4-s1    chunks in order also for several receivers
  256-16k-u4-s16   half the threads
  1024-16k-u4-s16  twice the threads
  512-32k-u4-s16   twice the keys a block
  512-16k-u2-s16   two vectors in flight a thread
  512-32k-u8-s16   eight vectors in flight a thread

holds each against segment_copy_plain byte for byte (every source x
receiver word offset past a 16-byte boundary, four ranks of real
schedules), then prints, twice in turn, the CUDA-event median of one launch
of 256Mi keys (one segment) into an aligned receiver and into one shifted
by a key, of a round of four launches of 64Mi keys (four segments each, of
ragged lengths, so most receivers lag their source), and of copy_ of the
same 256Mi keys, each through the C entry point.  Needs nvcc and a card.
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
from gpu_radix_sort_tpu_torch.ops.boundaries import digit_counts_sorted  # noqa: E402
from gpu_radix_sort_tpu_torch.ops.radix_sort import sort_by_digits  # noqa: E402
from gpu_radix_sort_tpu_torch.parallel import rdma_exchange as rx  # noqa: E402
from gpu_radix_sort_tpu_torch.utils import timers  # noqa: E402

GEOMETRY = ("constexpr int kCopyThreads = {threads};\n"
            "constexpr int kCopyChunk = {chunk};  // source keys a block sends\n"
            "constexpr int kCopyUnroll = {unroll};       // vectors a thread loads before it stores them\n"
            "constexpr int kCopyStripes = {stripes};     // interleaved stripes of chunks, for several receivers\n\n")
VARIANTS = {  # threads, chunk, unroll, stripes
    "512-16k-u4-s16": (512, "1 << 14", 4, 16),
    "512-16k-u4-s1": (512, "1 << 14", 4, 1),
    "256-16k-u4-s16": (256, "1 << 14", 4, 16),
    "1024-16k-u4-s16": (1024, "1 << 14", 4, 16),
    "512-32k-u4-s16": (512, "1 << 15", 4, 16),
    "512-16k-u2-s16": (512, "1 << 14", 2, 16),
    "512-32k-u8-s16": (512, "1 << 15", 8, 16),
}


def committed_geometry(text: str) -> str:
    start = text.index("constexpr int kCopyThreads = ")
    end = text.index("struct RankTable")
    return text[start:end]


def build_variants(root: Path) -> dict[str, ctypes.CDLL]:
    shutil.rmtree(root, ignore_errors=True)
    nvcc = build._nvcc()
    text = (build.CSRC / "exchange.cu").read_text()
    committed = committed_geometry(text)
    procs = {}
    for name, (threads, chunk, unroll, stripes) in VARIANTS.items():
        d = root / name
        d.mkdir(parents=True)
        shutil.copy(build.CSRC / "block_rank.cuh", d / "block_rank.cuh")
        geometry = GEOMETRY.format(threads=threads, chunk=chunk, unroll=unroll, stripes=stripes)
        (d / "exchange.cu").write_text(text.replace(committed, geometry))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(d / "lib.so"),
             str(d / "exchange.cu")], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(err)
        entry, regs = False, []
        for line in err.splitlines():
            if "Compiling entry function" in line:
                entry = "segment_copy_kernel" in line
            elif entry and "Used" in line:
                regs.append(line.split(" : ", 1)[-1].strip())
        print(f"ptxas [{name}]: segment_copy_kernel {'; '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        fn = lib.grs_segment_copy_u32
        fn.argtypes = build._SIGNATURES["grs_segment_copy_u32"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("copy_variants: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    libs = build_variants(build.BUILD_DIR / "copy_variants")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)

    def copy(lib, src, segs, recv) -> None:
        ptrs = (ctypes.c_longlong * len(recv))(*(r.data_ptr() for r in recv))
        status = lib.grs_segment_copy_u32(src.data_ptr(), src.numel(), segs.data_ptr(),
                                          segs.shape[1], ptrs, len(recv),
                                          torch.cuda.current_stream().cuda_stream)
        if status:
            raise SystemExit(f"copy_variants: CUDA error {status}")

    def placed(a: np.ndarray, shift: int) -> torch.Tensor:
        return torch.from_numpy(np.concatenate([np.zeros(shift, np.uint32), a])).to(dev)[shift:]

    # correctness: P = 4 real schedules at every offset pair
    P, n_local = 4, 3 * (1 << 14) + 5
    x = torch.from_numpy(rng.integers(0, 1 << 32, P * n_local, dtype=np.uint32)).view(P, -1)
    shards = [sort_by_digits(x[i].contiguous(), 8, 8) for i in range(P)]
    M = rx.send_matrix(torch.stack([digit_counts_sorted(s, 8, 8) for s in shards]), n_local)
    for name, lib in libs.items():
        for src_shift in range(4):
            for dst_shift in range(4):
                for i in range(P):
                    segs = rx.segments(M, i)
                    want = [torch.zeros(n_local, dtype=torch.uint32) for _ in range(P)]
                    rx.segment_copy_plain(shards[i], segs, want)
                    got = [placed(np.zeros(n_local, np.uint32), (dst_shift + c) % 4)
                           for c in range(P)]
                    copy(lib, placed(shards[i].numpy(), src_shift), segs.to(dev), got)
                    torch.cuda.synchronize()
                    for g, w in zip(got, want):
                        if not torch.equal(g.cpu().view(torch.int32), w.view(torch.int32)):
                            raise SystemExit(f"copy_variants: {name} differs from the plain "
                                             f"version (shifts {src_shift}, {dst_shift})")
    print("every variant equal to the plain version byte for byte", flush=True)

    n = 1 << 28
    part = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint32)).to(dev)
    one = torch.tensor([[0], [n], [0], [0]], dtype=torch.int64, device=dev)
    recv = torch.empty_like(part)
    recv_shifted = torch.empty(n + 4, dtype=torch.uint32, device=dev)[1:n + 1]
    quarters = [part[i * (n // 4):(i + 1) * (n // 4)] for i in range(4)]
    recv4 = [torch.empty(n // 4, dtype=torch.uint32, device=dev) for _ in range(4)]
    q = n // 16  # about a quarter of each sender's keys to each receiver
    ragged = torch.tensor([[1, -1, 3, -3], [-1, 1, -3, 3], [3, -3, 1, -1], [-3, 3, -1, 1]])
    M4 = q + ragged  # rows and columns still sum to n // 4
    segs4 = [rx.segments(M4, i).to(dev) for i in range(4)]
    for turn in range(2):
        t_copy = timers.time_cuda(lambda: recv.copy_(part))
        print(f"turn {turn} {'copy_':12s} [{card}]: {n} keys {t_copy:.4f} ms", flush=True)
        for name, lib in libs.items():
            t_one = timers.time_cuda(lambda: copy(lib, part, one, [recv]))
            t_shift = timers.time_cuda(lambda: copy(lib, part, one, [recv_shifted]))
            t_round = timers.time_cuda(
                lambda: [copy(lib, s, g, recv4) for s, g in zip(quarters, segs4)])
            print(f"turn {turn} {name:12s} [{card}]: one launch of {n} keys {t_one:.4f} ms, "
                  f"receiver shifted by a key {t_shift:.4f} ms; a round of 4 launches of "
                  f"{n // 4} keys {t_round:.4f} ms", flush=True)
    shutil.rmtree(build.BUILD_DIR / "copy_variants", ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
