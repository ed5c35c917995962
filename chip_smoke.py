#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels of gpu_radix_sort_tpu_torch/csrc with nvcc, and prints
   what ptxas says of the tile pass (block_sort), the merge level, the
   counting-sort kernels (digit_sort, group_sort_send), the one-block
   register network (single_block_sort at 2^14 keys) and segment_copy:
   registers, spills; and how many blocks of the tile pass, the merge level
   and the counting sorts fit an SM;
3. holds block_sort (tiles 1 to 2^14, a ragged last tile of each parity,
   also at 64M), single_block_sort (n from 1 to 2^14, aligned and shifted
   input), merge_level (L from 1 to 2^25, input at every word offset past a
   16-byte boundary), digit_sort and binning against their plain PyTorch
   versions, byte for byte, at small shapes and at the shapes of the main
   paths;
4. drives the first main path -- sort_full of 64M PCG32 keys (the onesweep
   route above ONESWEEP_MIN_N) -- with the launch counts set to 0 just
   before and read just after, exact against np.sort; then a ragged n, the
   one-block route (single_block_sort, its launch count), int32/float32
   keys and sort_partial(stable=False) against the reference's boundary
   contract; then the onesweep sort on its own (onesweep_path, as
   ``--onesweep`` below);
5. drives the second main path -- the stable sort_partial of 256Mi PCG32
   keys at widths 4, 8 and 16 -- the same way, exact against the numpy
   stable oracle, its boundaries and its counts; then the kv digit sort
   with an arange column and the one-block digit-sort route;
6. times each path, its torch.sort yardstick, each kernel and its plain
   version by the CUDA-event median (the one-block sorts and their
   torch.sort also as a CUDA graph of 20 calls, device time alone, beside
   the one-block counting route), B5's library call (a stable torch.sort of
   the digits), profiles sort_full and the partial sorts by kernel
   (torch.profiler);
7. drives the key-value, 64-bit and table paths at the JAX harness's sizes
   (kv_table_path), each with the launch counts set to 0 just before and
   read just after and exact against a numpy oracle: sort_key_value of
   128Mi PCG32 keys with 8- and 64-byte payloads and as float32 keys;
   sort_key_value_by_digits(0, 8) of the 256Mi keys with (n, 4) uint32
   lanes, binning_pass_kv; sort_full_u64, sort_partial_u64 and
   sort_partial_counts_u64 at (0, 8) and (28, 16), stable and not, of 256Mi
   uint64 keys, sort_key_value_u64 of 128Mi of them with 8 bytes, int64 and
   float64 keys (NaNs, +-0.0) at 2^20; partition_by_ids of the 256Mi keys
   into 256 parts, filter_range, and group_aggregate count, uint32 sum and
   float32 sum (the same bytes on two calls, within 1e-5 of float64 sums)
   over 256Mi Zipf(1.1) keys; times each and its "torch" route, its peak
   memory, and profiles the 64-byte kv sort and sort_partial_u64(28, 16);
8. holds segment_copy (B6) and group_sort_send (B7) against their plain
   versions byte for byte, on 1 to 8 ranks of one card, schedules from
   uniform, duplicate, presorted, skewed and all-equal keys, 64Mi keys a
   rank on 4 ranks, and B6 at every word offset of source and receivers
   past a 16-byte boundary on 1 and 4 ranks;
9. drives the third main path -- sort_distributed of the same 256Mi keys at
   width 8 through exchange="rdma" on key_mesh() -- with the launch counts
   set to 0 just before and read just after, exact against np.sort; then on
   four ranks of cuda:0 through "rdma" and "rdma_overlap" the same way, and
   width 16, the collective exchanges, all-equal and typed keys;
10. times the mesh sorts, one tile pass and one merge level of the 256Mi
   keys, one B6 launch (destination aligned and shifted by one key, beside
   copy_ of the same bytes) and one B7 round, and profiles the one-rank rdma
   sort and the four-rank rdma_overlap sort by kernel;
11. drives the mesh sample sort (PSRS, sample_path) of the same 256Mi keys
   on one rank and on four ranks of cuda:0, with reassembly "sort" and
   "merge", each with the launch counts set to 0 just before and read just
   after, exact against np.sort; shards of <= 2^14 keys (B3); int32 and
   float32 keys at 2^20; all-equal and 256Mi Zipf(1.1) keys with no
   fallback; reverse block-sorted keys at 16Mi, OverflowError_ without the
   fallback and exact through it; sort_key_value_distributed of 128Mi rows
   of 8 bytes and 32Mi of 64 bytes; sort_distributed_64 of the 256Mi
   uint64 keys in one pass and of 64Mi through the LSD composition;
   sort_key_value_distributed_64 of 128Mi rows of 8 bytes; times each
   beside torch.sort of the same keys and the four-rank mesh LSD rdma sort,
   its peak memory, and profiles the four-rank 32-bit sorts;
12. drives the distributed hash aggregate (aggregate_path) at the JAX
   harness's cell, the count over 256Mi Zipf(1.2) keys (seed 9) on four
   ranks of cuda:0 and on one, each with the launch counts set to 0 just
   before and read just after, exact against np.unique with overflow 0,
   no host wait inside it, its time, peak memory and (four ranks) profile,
   beside torch.unique and group_aggregate of the same keys; float32 sum,
   uint32 max, a predicate and key_order=True on four ranks of 16Mi keys;
   the selftest's 12 500-key aggregate (B3); the key_order crossover; and
   ``python -m gpu_radix_sort_tpu_torch selftest --n 100000`` as a child
   process, which must pass; then the multi-process mesh (multihost_path):
   one child process over NCCL holding four ranks of cuda:0, then two
   child processes of two ranks over gloo, staged through host memory,
   each driving the LSD sort (alltoall, w8, capacity 1.5), PSRS "sort" and
   "merge" of the same 256Mi keys and the count aggregate of the Zipf(1.2)
   keys through their build functions, with the launch counts set to 0
   just before and read just after, exact against np.sort and np.unique,
   the torch.distributed calls counted (the same whatever the ranks a
   process holds), no host wait inside the NCCL calls, times (CUDA events
   beside the single-controller mesh of the same ranks and torch.sort;
   host clock through barriers over gloo) and the bytes staged; the LSD
   sort also through rdma and rdma_overlap, whose B6 and B7 store into the
   receive buffers of the other process through CUDA IPC over gloo (only
   the digit counts staged), with one exchange round of each timed; before
   the paths, each process holds the raw rounds of B6 and B7 (receive
   buffers aligned and at word offsets 1-3) against the single
   controller's, byte for byte; then dryrun_multichip(8) on eight ranks of
   cuda:0 (gpu_radix_sort_tpu_torch/dryrun.py, nine exact checks);
13. drives the storage plane at the reference's distributed configuration
   (storage_path): sort_distrib_from_raw of 512Mi PCG32 keys at width 8
   over 2 workers, exact against one np.sort, with launch counts: sort_full
   of the 2^29 keys; the device backend's fused loop (times of 3 calls,
   SortStats phases, peak memory, a profile), its rounds with checkpoints
   per worker (B5) and fused, a worker raising in round 3 at 64Mi and
   resume_sort_distrib; the file backend with a WorkerPool of 2 processes
   on the card; the mem backend at 128Mi; shards of 2^14 keys (B4) and the
   fused loop at 2^14 keys (B3); kv rows with 64-byte payloads at 32Mi
   (numpy's stable order); uint64 keys at 256Mi (the fused 64-bit loop)
   and at 64Mi with checkpoints; and times the copies of 2 GiB to and from
   the card;
14. drives the benchmark harness (bench_path): ``python -m
   gpu_radix_sort_tpu_torch bench --suite full --json`` as a child process,
   whose 22 records must be the JAX suite's rows in order, each with a
   median above 0, overflow 0 where it is counted and the storage rows'
   rounds (written to chiprun_out/bench_full.jsonl and printed as the
   harness prints them); ``analyze`` of the file alone and against itself
   (every row 1.00x); the native PCG32 fill of 256Mi keys against the numpy
   fill (the same words, both timed); one call of every row that runs on
   the card, at the suite's size, with the launch counts set to 0 just
   before and read just after (full_sort_u32 B1 and B2, the partial sorts
   B5 1/2/4 times, kv_sort_u32_p8B, kv_digit_sort_w4 and the 64-byte kv
   sort B5, hash_aggregate_count_zipf B1, B2 and B5, each exactly; the
   64-bit rows and the kv and 64-bit storage rows none, as JAX's run no
   Pallas kernel; the other mesh and storage rows some kernel); and the
   harness's full_sort_u32 median at 256Mi within 15% of time_cuda of the
   same sort in the same process;
15. drives the out-of-core runner
   (gpu_radix_sort_tpu_torch/benchmarks/run_out_of_core.py, out_of_core_path)
   in this process through its ``main`` at the published widths and a cut
   depth: 2^27 PCG32 keys (4-byte rows) and 2^23 rows with 64-byte payloads
   (68-byte rows), width 8, two workers, on the file backend in
   _ooc_smoke/ (removed after), each with the launch counts set to 0 just
   before and read just after (B5 16 times for the keys, no kernel for the
   kv rows, whose digit order is a torch.sort as JAX's is an XLA sort),
   exit 0 and "exact" true required; logs its JSON line, its SortStats
   phases, a breakdown of its host clock (staging, the workers' file
   reads, sorts on the card and bucket writes, the rest, the proof), its
   peak host memory, disk and device memory.

Prints one JSON line of per-kernel results, then, as the last line,
{"ok": true, "device": {...}}.  Any failed check raises and exits non-zero.
Without a CUDA device it exits 1 and prints no result.

    python3 chip_smoke.py --all-cards

runs only the mesh sorts (LSD and sample) across every visible card (two or
more), the route one card cannot reach: B6 and B7 store through peer access into the
other cards' buffers, and events order the cards' streams.  It holds both
kernels against their plain versions across cards (B6 also at every word
offset of source and receivers past a 16-byte boundary), sorts the same 256Mi
keys exactly through rdma, rdma_overlap and alltoall with launch counts,
and times each sort, a B6 round and a B7 round (overlapped and serial)
across the cards against the same work on as many ranks of cuda:0; and the
same for the sample sort, both reassemblies, and the hash aggregate count of
256Mi Zipf(1.2) keys; then four child processes over NCCL, one card each
(pod_key_mesh()), run the LSD sort (alltoall, and rdma and rdma_overlap
storing across the cards into each other's buffers through CUDA IPC) and
PSRS at 256Mi and 1Gi keys in all and the count aggregate, exact, beside the
single-controller mesh of the same cards, after the raw rounds of B6 and
B7 across the cards; then dryrun_multichip over the cards.

    python3 chip_smoke.py --multihost

builds the kernels and runs only the multi-process phases of 12. on one
card, making their oracles beside the build (``--multihost-child`` is the
children's own entry, started with torchrun's variables).

    python3 chip_smoke.py --storage

builds the kernels and runs only the storage path (13. above) on one card.

    python3 chip_smoke.py --sample

builds the kernels and runs only the sample path (11. above) on one card,
making its oracles itself.

    python3 chip_smoke.py --aggregate

builds the kernels and runs only the hash-aggregate path (12. above) on one
card, making its inputs and oracles beside the build.

    python3 chip_smoke.py --bench

builds the kernels and runs only the harness step (14. above) on one card.

    python3 chip_smoke.py --onesweep

builds the kernels and runs only the onesweep sort (onesweep_path): its
geometry against the wrapper's; exactness against torch.sort at 2^15, 2^20,
256Mi, 320Mi + 256 and 2^29 keys, at every input word offset past a 16-byte
boundary, for several kinds of keys (the input left unwritten), and against
its plain version; its time at 256Mi and 320Mi + 256 beside its bound, its
plain version, torch.sort and the merge route, a profile by kernel and its
scratch; the crossover sweep against the merge route at 2^15 .. 2^22; and
the launches of sort_full at 2^29 and at either side of ONESWEEP_MIN_N, of
sort_partial(stable=False) and of the mesh LSD sort on four ranks of one
card.

    python3 chip_smoke.py --out-of-core

builds the kernels and runs the out-of-core runner (15. above) at its two
published configurations, unchanged: 1Gi keys, and 256Mi rows with 64-byte
payloads (width 8, one worker).  Before each it checks the mount's free
disk (the input and one round's outputs, twice the rows' bytes, and 1 GiB)
and the host's available memory (three times the rows' bytes, and 4 GiB),
and fails with the numbers if either is short.  The plain run never runs
it: it takes ~8 minutes.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN = 1 << 26  # 64M keys, 256 MiB: the sort_full path's size
N_PART = 1 << 28  # 256Mi keys, 1 GiB: the stable partial sorts' size
PART_WIDTHS = (4, 8, 16)
N_MESH = N_PART  # the mesh LSD sort's size: the same 256Mi keys
MESH_RANKS = 4  # ranks on one card for the multi-rank runs
# The storage plane at the reference's distributed configuration: 512Mi
# keys (2 GiB), width 8, 2 workers (BASELINE.md:10, 28; distrib.go:107)
N_STORAGE = 1 << 29
STORAGE_WIDTH = 8
STORAGE_WORKERS = 2
N_STORAGE_CRASH = 1 << 26  # crash and resume; 64-bit keys with checkpoints
N_STORAGE_MEM = 1 << 27  # the mem backend
N_STORAGE_KV = 1 << 25  # key-value rows with 64-byte payloads
N_STORAGE_U64 = 1 << 28  # 64-bit keys, the fused 64-bit loop

# Published peaks of one H100 SXM: HBM bytes/s, and 32-bit operations/s
# outside the tensor cores (the float32 row of the data sheet).
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_lines() -> list[str]:
    """Name and power limit of each card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()


def card_line() -> str:
    return card_lines()[0]


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Kernels whose ptxas report is printed: name -> (text of its entry's
# mangled name, source); the register network at 2^14 keys.
PTXAS_KERNELS = {
    "block_sort_kernel": ("17block_sort_kernel", "block_sort.cu"),
    "merge_level_kernel": ("18merge_level_kernel", "merge_path.cu"),
    "digit_sort_kernel": ("digit_sort_kernel", "block_sort.cu"),
    "group_sort_send_kernel": ("group_sort_send_kernel", "exchange.cu"),
    "single_block_sort_kernel<14>": ("single_block_sort_kernelILi14E", "block_sort.cu"),
    "segment_copy_kernel": ("segment_copy_kernel", "exchange.cu"),
    "onesweep_histogram_kernel": ("25onesweep_histogram_kernel", "onesweep.cu"),
    "onesweep_pass_kernel": ("20onesweep_pass_kernel", "onesweep.cu"),
}


def start_ptxas_report():
    """One ``nvcc -Xptxas -v -c`` a source of the kernels of PTXAS_KERNELS,
    started now so that it runs beside the build."""
    from gpu_radix_sort_tpu_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted({src for _, src in PTXAS_KERNELS.values()}):
        obj = build.BUILD_DIR / f"ptxas.{os.getpid()}.{src}.o"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
               str(build.CSRC / src)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                            stderr=subprocess.PIPE, text=True)))
    return procs


def ptxas_report(procs) -> dict:
    """What ptxas said of each kernel of PTXAS_KERNELS: its frame and
    spills, and its registers, barriers and static shared memory."""
    report = {}
    for obj, proc in procs:
        _, err = proc.communicate()
        obj.unlink(missing_ok=True)
        if proc.returncode:
            fail(f"nvcc -Xptxas -v failed:\n{err}")
        name = None
        for line in err.splitlines():
            if "Compiling entry function" in line:
                name = next((k for k, (key, _) in PTXAS_KERNELS.items() if key in line), None)
            elif name and ("spill" in line or "Used" in line):
                report.setdefault(name, []).append(line.split(" : ", 1)[-1].strip())
    return report


def blocks_per_sm(lib, fn: str, *args) -> tuple[int, int]:
    """(blocks a SM, dynamic shared memory bytes) of a kernel at the launch
    ``args`` describe, from the CUDA occupancy calculator."""
    import ctypes

    from gpu_radix_sort_tpu_torch.kernels import build

    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    build.check(getattr(lib, fn)(*args, ctypes.byref(blocks), ctypes.byref(smem)), fn)
    return blocks.value, smem.value


def graph_ms(fn, calls: int = 20) -> float:
    """Device milliseconds a call of ``fn``: ``calls`` calls captured in one
    CUDA graph and replayed between CUDA events (median of 10), so the host
    work of each call is not counted.  For calls of a few microseconds,
    where a single call's events mostly time the host."""
    from gpu_radix_sort_tpu_torch.utils import timers

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # the first call outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return timers.time_cuda(graph.replay) / calls


def back_to_back_ms(fn, calls: int = 10) -> float:
    """Milliseconds a call of ``fn``: ``calls`` calls back to back between
    CUDA events (median of 10).  For calls of a millisecond or so whose
    host work is tens of microseconds: it runs while the previous call's
    kernel does, so only the first call's shows, a ``calls``-th of it.
    (A CUDA graph would turn copy_ into a memcpy node, which the copy
    engines run more slowly than copy_'s kernel.)"""
    from gpu_radix_sort_tpu_torch.utils import timers

    return timers.time_cuda(lambda: [fn() for _ in range(calls)]) / calls


def network_stages(size: int) -> int:
    """Compare-exchange stages of a bitonic network over size keys."""
    log = size.bit_length() - 1
    return log * (log + 1) // 2


def device_profile(fn, reps: int = 3):
    """Device time by kernel name (ms a call) and the device's idle share
    between the first and the last kernel, from torch.profiler over ``reps``
    calls; None where the profiler saw no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return None
    by_name: dict[str, float] = {}
    busy, cur_start, cur_end = 0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3 / reps
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = spans[-1][1] - spans[0][0]
    return by_name, 1.0 - busy / window if window else 0.0


def kernel_launches_ms(fn, reps: int = 5) -> dict[str, list[float]] | None:
    """Each device kernel's time (ms) at every launch the profiler saw over
    ``reps`` calls of ``fn``, by kernel name; None where it saw none.  A
    mean a launch holds where the profiler misses a call's kernels, which
    a sum over ``reps`` does not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            times.setdefault(e.name, []).append((e.time_range.end - e.time_range.start) / 1e3)
    return times or None


def storage_path(dev, card: str, head: np.ndarray | None = None, stream=None) -> dict:
    """The storage plane at the reference's distributed configuration: 512Mi
    PCG32 keys (2 GiB), digit width 8, 2 workers, 4 rounds (BASELINE.md:10,
    28; distrib.go:107), through sort_distrib_from_raw on every backend.
    Each run has its launch counts set to 0 just before and read just
    after, and is exact against one numpy oracle; times are host-clock ends
    of whole calls (each ends in its copy to the host) with their SortStats
    phases, beside torch.sort of the same keys.  ``head``: the first keys
    of the PCG32 stream, already made, and ``stream`` the Pcg32 that made
    them, which goes on from there.  Returns the results for the JSON
    line."""
    import shutil

    from gpu_radix_sort_tpu_torch import data as pdata
    from gpu_radix_sort_tpu_torch.ops import binning as bn
    from gpu_radix_sort_tpu_torch.ops import block_sort as bs
    from gpu_radix_sort_tpu_torch.ops import digit_sort as ds
    from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
    from gpu_radix_sort_tpu_torch.ops import onesweep as osw
    from gpu_radix_sort_tpu_torch.ops import radix_sort as rs
    from gpu_radix_sort_tpu_torch.ops import single_block as sb
    from gpu_radix_sort_tpu_torch.parallel import serverless as sv
    from gpu_radix_sort_tpu_torch.parallel import storage_sort as ss
    from gpu_radix_sort_tpu_torch.utils import keygen, timers
    from gpu_radix_sort_tpu_torch.utils.timers import SortStats

    counters = {"onesweep": osw, "block_sort": bs, "merge_level": ms, "digit_sort": ds,
                "binning": bn, "single_block_sort": sb}
    none = dict.fromkeys(counters, 0)
    res = {"launches": {}, "peak_mib": {}, "ms": {}, "phases_s": {}, "torch_ms": {},
           "card": card}
    width, nworker, nstep = STORAGE_WIDTH, STORAGE_WORKERS, 32 // STORAGE_WIDTH

    def run(name: str, fn, expect: dict):
        """fn() with the counts set to 0 just before and read just after;
        fails unless they are ``expect`` (kernels not named: 0)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for mod in counters.values():
            mod.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res["ms"][name] = (time.perf_counter() - t0) * 1e3
        got = {k: mod.launches for k, mod in counters.items()}
        want = {**none, **expect}
        if got != want:
            fail(f"{name}: launches {got}, expected {want}")
        res["launches"][name] = {k: v for k, v in got.items() if v}
        res["peak_mib"][name] = (torch.cuda.max_memory_allocated() - held) / 2**20
        return out

    def exact(got: np.ndarray, want: np.ndarray, what: str) -> None:
        if got.dtype != want.dtype or got.shape != want.shape or not np.array_equal(
                got.view(np.uint8), want.view(np.uint8)):
            fail(f"{what} differs from the numpy oracle")

    def report(name: str, stats: SortStats, n_keys: int, n_calls: int = 1,
               key_type: str = "u32") -> None:
        res["phases_s"][name] = {k: v["total_s"] / n_calls for k, v in stats.report().items()
                                 if isinstance(v, dict)}
        split = ", ".join(f"{k} {v:.4f}" for k, v in res["phases_s"][name].items())
        res["torch_ms"][name] = yardstick[(key_type, n_keys)]
        log(f"time [{card}]: {name}: {res['ms'][name]:.1f} ms by host clock, launches "
            f"{res['launches'].get(name)}, peak device memory "
            f"{res['peak_mib'].get(name, float('nan')):.0f} MiB above its inputs; "
            f"torch.sort of the same {n_keys} keys on the card {res['torch_ms'][name]:.3f} "
            f"ms; phases a call (s): {split}")

    t_path = time.perf_counter()
    n = N_STORAGE
    if head is None:
        head, stream = np.empty(0, np.uint32), keygen.Pcg32()
    keys_np = np.concatenate([head, stream.fill(n - head.size)])
    del head
    t0 = time.perf_counter()
    want = np.sort(keys_np)
    log(f"storage path: {n} PCG32 keys made; np.sort oracle in "
        f"{time.perf_counter() - t0:.1f} s")
    h2d = timers.time_cuda(lambda: torch.from_numpy(keys_np).to(dev), warmup=1, iters=3)
    keys = torch.from_numpy(keys_np).to(dev)
    d2h = timers.time_cuda(lambda: keys.cpu(), warmup=1, iters=3)
    res["h2d_ms"], res["d2h_ms"] = h2d, d2h
    log(f"time [{card}]: {n * 4} bytes host to device {h2d:.3f} ms, device to host "
        f"{d2h:.3f} ms (pageable host memory; CUDA-event median of 3)")

    # -- sort_full of 2^29 keys, the fused loops' global sort ----------------
    out = run(f"sort_full {n}", lambda: rs.sort_full(keys), full_sort_launches(n))
    exact(out.cpu().numpy(), want, f"sort_full of {n} keys")
    del out
    res["sort_full_ms"] = timers.time_cuda(lambda: rs.sort_full(keys), iters=5)
    res["torch_sort_ms"] = timers.time_cuda(lambda: rs.sort_full(keys, strategy="torch"),
                                            iters=5)
    log(f"time [{card}]: sort_full of {n} keys {res['sort_full_ms']:.3f} ms, torch.sort "
        f"{res['torch_sort_ms']:.3f} ms (CUDA-event median of 5); exact")
    # torch.sort of each phase's keys on the card, the yardstick of its time
    yardstick = {("u32", m): timers.time_cuda(
        lambda m=m: rs.sort_full(keys[:m], strategy="torch"), iters=5)
        for m in (N_STORAGE_CRASH, N_STORAGE_MEM, N_STORAGE_KV)}
    yardstick[("u32", n)] = res["torch_sort_ms"]

    # -- device backend, stock worker, no checkpoint: the fused loop ---------
    fused_expect = launches_sum(full_sort_launches(n, nstep - 1),
                                full_sort_launches(n // nworker, nworker))
    f = pdata.DeviceArrayFactory(dev)
    name = "device fused"
    stats = SortStats()
    got = run(name, lambda: ss.sort_distrib_from_raw(keys, "sd", f, width=width,
                                                      nworker=nworker, stats=stats),
              fused_expect)
    exact(got, want, f"storage {name}")
    del got
    stats = SortStats()
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        ss.sort_distrib_from_raw(keys, "sd", f, width=width, nworker=nworker, stats=stats)
        samples.append((time.perf_counter() - t0) * 1e3)
    res["ms"][name] = float(np.median(samples))
    report(name, stats, n, 3)
    log_profile(card, f"storage {name} of {n} keys (one call: its rounds and its copy "
                f"to the host)", lambda: ss.sort_distrib_from_raw(
                    keys, "sd", f, width=width, nworker=nworker), top=8)

    # -- device backend with checkpoints: the per-worker and fused rounds ----
    ckpt_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_storage_smoke")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    manifests = []
    write_checkpoint = ss._write_checkpoint

    def counting_checkpoint(*args, **kwargs):
        write_checkpoint(*args, **kwargs)
        manifests.append(ss.load_checkpoint(args[0], args[1]))

    ss._write_checkpoint = counting_checkpoint
    try:
        name = "device per-worker checkpointed"
        stats = SortStats()
        pinned = ss.make_local_worker("auto")
        got = run(name, lambda: ss.sort_distrib_from_raw(
            keys, "sc", f, pinned, width=width, nworker=nworker, stats=stats,
            checkpoint_dir=os.path.join(ckpt_root, "pw")),
            {"binning": nstep * nworker * -(-width // bn.PASS_WIDTH)})
        exact(got, want, f"storage {name}")
        if [m["completed_step"] for m in manifests] != list(range(nstep)):
            fail(f"{name}: manifests of steps {[m['completed_step'] for m in manifests]}")
        report(name, stats, n)
        manifests.clear()
        name = "device fused checkpointed"
        stats = SortStats()
        got = run(name, lambda: ss.sort_distrib_from_raw(
            keys, "sk", f, width=width, nworker=nworker, stats=stats,
            checkpoint_dir=os.path.join(ckpt_root, "fu")),
            launches_sum(full_sort_launches(n, nstep - 1),
                         full_sort_launches(n // nworker, nstep * nworker)))
        exact(got, want, f"storage {name}")
        if [m["completed_step"] for m in manifests] != list(range(nstep)):
            fail(f"{name}: manifests of steps {[m['completed_step'] for m in manifests]}")
        report(name, stats, n)
        del got
    finally:
        ss._write_checkpoint = write_checkpoint

    # -- crash in round 3 at 64Mi, then resume_sort_distrib ----------------
    n_crash = N_STORAGE_CRASH
    want_crash = np.sort(keys_np[:n_crash])

    def crashing(in_refs, offset, w, out_name, factory):
        if offset == 2 * width:
            raise RuntimeError("worker down in round 3")
        return pinned(in_refs, offset, w, out_name, factory)

    ckpt = os.path.join(ckpt_root, "crash")
    try:
        ss.sort_distrib_from_raw(keys[:n_crash], "sx", f, crashing, width=width,
                                 nworker=nworker, checkpoint_dir=ckpt)
        fail("the crashing worker did not crash")
    except RuntimeError as e:
        if "round 3" not in str(e):
            raise
    if ss.load_checkpoint(ckpt, "sx")["completed_step"] != 1:
        fail("crash: the last manifest is not round 2's")
    outs = ss.resume_sort_distrib("sx", f, ss.local_distrib_worker, ckpt, nworker=nworker)
    exact(ss._linearize(outs, SortStats()).view(np.uint32), want_crash,
          f"resume after a crash in round 3 at {n_crash}")
    del want_crash
    log(f"storage path: device backend with checkpoints, a manifest a round; a worker "
        f"raising in round 3 at {n_crash} keys, then resume_sort_distrib: exact")

    # -- file backend, a WorkerPool of 2 processes on the card --------------
    mount = os.path.join(ckpt_root, "mount")
    with sv.WorkerPool(mount, size=nworker) as pool:
        warm = keys_np[: 1 << 20]
        got = ss.sort_distrib_from_raw(warm, "sw", pdata.FileArrayFactory(mount),
                                       pool.worker(), width=width, nworker=nworker)
        exact(got, np.sort(warm), "file pool warm-up sort")
        name = "file pool"
        stats = SortStats()
        got = run(name, lambda: ss.sort_distrib_from_raw(
            keys_np, "sf", pdata.FileArrayFactory(mount), pool.worker(), width=width,
            nworker=nworker, stats=stats), {})  # the launches are the children's
        exact(got, want, f"storage {name}")
        del got
    report(name, stats, n)
    shutil.rmtree(ckpt_root, ignore_errors=True)

    # -- mem backend, local worker, 128Mi ----------------------------------
    n_mem = N_STORAGE_MEM
    want_mem = np.sort(keys_np[:n_mem])
    name = "mem local"
    stats = SortStats()
    got = run(name, lambda: ss.sort_distrib_from_raw(
        keys_np[:n_mem], "sm", pdata.MemArrayFactory(), width=width, nworker=nworker,
        stats=stats), {"binning": nstep * nworker * -(-width // bn.PASS_WIDTH)})
    exact(got, want_mem, f"storage {name} at {n_mem}")
    report(name, stats, n_mem)
    del got, want_mem

    # -- shards of <= 2^14 keys: B4 in the workers, B3 in the fused loop ----
    n_small = nworker * ds.MAX_N_KV
    got = run("mem local small", lambda: ss.sort_distrib_from_raw(
        keys_np[:n_small], "ss", pdata.MemArrayFactory(), width=width, nworker=nworker),
        {"digit_sort": nstep * nworker})
    exact(got, np.sort(keys_np[:n_small]), f"storage mem local at {n_small}")
    n_tiny = sb.MAX_N
    got = run("device fused small", lambda: ss.sort_distrib_from_raw(
        keys[:n_tiny], "st", f, width=width, nworker=nworker),
        {"single_block_sort": nstep - 1 + nworker})
    exact(got, np.sort(keys_np[:n_tiny]), f"storage device fused at {n_tiny}")
    log(f"storage path: shards of {ds.MAX_N_KV} keys through digit_sort, and the fused "
        f"loop at {n_tiny} keys through single_block_sort: exact")
    del keys, want

    # -- kv rows: 64-byte payloads at 32Mi rows, mem backend -----------------
    n_kv = N_STORAGE_KV
    kv_keys = keys_np[:n_kv]
    payload = keygen.generate_payloads(n_kv, payload_bytes=64)
    name = "mem kv p64B"
    stats = SortStats()
    sk, sp = run(name, lambda: ss.sort_distrib_from_raw_kv(
        kv_keys, payload, "kv", pdata.MemArrayFactory(), width=width, nworker=nworker,
        stats=stats), {})  # the digit order is a torch.sort, no kernel
    order = stable_order_u32(kv_keys)
    exact(sk, kv_keys[order], f"storage {name} keys")
    exact(sp, take_rows(payload, order), f"storage {name} payload")
    report(name, stats, n_kv)
    del sk, sp, order, payload, kv_keys, keys_np

    # -- 64-bit keys: 256Mi uint64 on the device backend (the fused loop) ----
    n64 = N_STORAGE_U64
    u64_np = np.random.default_rng(64).integers(0, 1 << 64, n64, dtype=np.uint64)
    want64 = np.sort(u64_np)
    name = "device u64 fused"
    stats = SortStats()
    got = run(name, lambda: ss.sort_distrib_from_raw_u64(
        u64_np, "su", f, width=width, nworker=nworker, stats=stats), {})
    exact(got, want64, f"storage {name}")
    u64 = torch.from_numpy(u64_np).to(dev).view(torch.int64)
    for m in (n64, N_STORAGE_CRASH):  # the int64 sort of the sign-flipped words
        yardstick[("u64", m)] = timers.time_cuda(
            lambda m=m: torch.sort(u64[:m] ^ (-1 << 63)), iters=5)
    res["u64_torch_sort_ms"] = yardstick[("u64", n64)]
    report(name, stats, n64, key_type="u64")
    del u64, got
    n64c = N_STORAGE_CRASH
    name = "device u64 checkpointed"
    stats = SortStats()
    got = run(name, lambda: ss.sort_distrib_from_raw_u64(
        u64_np[:n64c], "sv", f, width=width, nworker=nworker, stats=stats,
        checkpoint_dir=os.path.join(ckpt_root, "u64")), {})
    exact(got, np.sort(u64_np[:n64c]), f"storage {name} at {n64c}")
    report(name, stats, n64c, key_type="u64")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    del got, want64, u64_np
    torch.cuda.empty_cache()
    log(f"storage path: every phase exact ({time.perf_counter() - t_path:.1f} s)")
    res.update(n=N_STORAGE, width=width, nworker=nworker, n_crash=N_STORAGE_CRASH,
               n_mem=N_STORAGE_MEM, n_kv=N_STORAGE_KV, n_u64=N_STORAGE_U64)
    return res


def side_pool(workers: int = 1):
    """A pool of processes of its own for inputs and oracles made beside
    the run: numpy's Zipf draws take about a minute at 256Mi and hold the
    interpreter lock.  Shut it down after."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))


def start_zipf_keys(n: int):
    """(pool, future) of generate_zipf_keys(n, alpha=1.1) in a
    :func:`side_pool`, started now, so that the draws run beside the phases
    before the table path instead of in its way."""
    from gpu_radix_sort_tpu_torch.utils import keygen

    pool = side_pool()
    return pool, pool.submit(keygen.generate_zipf_keys, n, alpha=1.1)


def total_order_np(a: np.ndarray) -> np.ndarray:
    """numpy IEEE-754 totalOrder bits of float32 keys (independent of the
    port's torch codec)."""
    u = a.view(np.uint32)
    return u ^ np.where(u >> np.uint32(31), np.uint32(0xFFFFFFFF), np.uint32(0x80000000))


def total_order_np64(a: np.ndarray) -> np.ndarray:
    """numpy IEEE-754 totalOrder bits of int64 / float64 keys as uint64
    (independent of the port's codecs)."""
    u = a.view(np.uint64)
    if a.dtype == np.int64:
        return u ^ np.uint64(1 << 63)
    return u ^ np.where(u >> np.uint64(63), np.uint64((1 << 64) - 1), np.uint64(1 << 63))


def stable_order_u32(k: np.ndarray) -> np.ndarray:
    """np.argsort(k, kind="stable") of uint32 keys, as one sort of the
    distinct (key << 32 | index) words: the same permutation in seconds
    where the timsort of 2^27 keys takes tens of them."""
    idx = np.arange(k.size, dtype=np.uint64)
    return (np.sort((k.astype(np.uint64) << np.uint64(32)) | idx) & np.uint64(0xFFFFFFFF)).astype(np.int64)


def take_rows(a: np.ndarray, order: np.ndarray) -> np.ndarray:
    """a[order] for (n, B) uint8 rows, indexing each row as one fixed-size
    record: numpy's 2-D row indexing copies element by element, 2-4x
    slower on these sizes."""
    records = np.ascontiguousarray(a).view(np.dtype((np.void, a.shape[1]))).reshape(-1)
    return records[order].view(a.dtype).reshape(-1, a.shape[1])


def hash_np(k: np.ndarray) -> np.ndarray:
    """The table operators' uint32 hash in numpy uint32 arithmetic."""
    with np.errstate(over="ignore"):
        x = k.astype(np.uint32) * np.uint32(2654435769)
        x ^= x >> np.uint32(15)
        x = x * np.uint32(0x2C1B3C6D)
        x ^= x >> np.uint32(12)
    return x


def run_starts(sorted_keys: np.ndarray) -> np.ndarray:
    """Indices where a run of equal keys starts."""
    return np.flatnonzero(np.concatenate([[True], sorted_keys[1:] != sorted_keys[:-1]]))


def exchange_inputs(rng, n: int):
    """The key distributions the exchange kernels are held on: their
    schedules run from even to all-in-one-peer, with empty segments."""
    yield "uniform", rng.integers(0, 1 << 32, n, dtype=np.uint32)
    yield "duplicate", rng.integers(0, 4, n, dtype=np.uint32) << np.uint32(8)
    yield "presorted", np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint32))
    yield "skewed", (rng.zipf(1.3, n) % (1 << 16)).astype(np.uint32) << np.uint32(8)
    yield "equal", np.full(n, 0x9E3779B9, np.uint32)


def same_bytes(got: list, want: list, what: str) -> int:
    """0 when each tensor of ``got`` equals its counterpart in ``want`` byte
    for byte (compared on got's device; want may lie elsewhere); else fail."""
    for d in {g.device for g in got if g.device.type == "cuda"}:
        torch.cuda.synchronize(d)
    for r, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g.view(torch.int32), w.to(g.device).view(torch.int32)):
            fail(f"{what}: rank {r} differs from the plain version")
    return 0


def b6_round(shards: list):
    """A function that runs one round of B6 over ``shards`` (one a rank, by
    digit 0..7): the digit sorts and the schedule are made here, once."""
    from gpu_radix_sort_tpu_torch.ops.boundaries import digit_counts_sorted
    from gpu_radix_sort_tpu_torch.ops.radix_sort import sort_by_digits
    from gpu_radix_sort_tpu_torch.parallel import rdma_exchange as rx
    from gpu_radix_sort_tpu_torch.parallel.mesh import all_gather

    n_local = shards[0].numel()
    sorted_ = [sort_by_digits(s, 0, 8) for s in shards]
    counts = all_gather([digit_counts_sorted(s, 0, 8) for s in sorted_])
    segs = [rx.segments(rx.send_matrix(c, n_local), i) for i, c in enumerate(counts)]
    recv = [torch.empty_like(s) for s in shards]

    def run():
        rx.begin_sends(sorted_, recv)
        for s, seg in zip(sorted_, segs):
            rx.segment_copy(s, seg, recv)
        rx.end_sends(sorted_, recv)
    return run


def b7_round(shards: list, mode: str):
    """A function that runs one round of B7 over ``shards`` (digit 0..7,
    the largest tile): ``mode`` "send" (overlapped), "serial" (sort-only
    launches, then B6) or "plain" (the plain version)."""
    from gpu_radix_sort_tpu_torch.parallel import rdma_exchange as rx
    from gpu_radix_sort_tpu_torch.parallel import rdma_overlap as ov
    from gpu_radix_sort_tpu_torch.parallel.mesh import all_gather

    n_local = shards[0].numel()
    tile = ov.pick_tile(n_local)
    hists = all_gather([ov._group_hist(s, 0, 8, tile) for s in shards])
    scheds = [torch.stack(ov.overlap_schedule(h, n_local))[:, i].contiguous()
              for i, h in enumerate(hists)]
    segs = [ov.group_segments(sched, tile) for sched in scheds]
    recv = [torch.empty_like(s) for s in shards]

    def run():
        rx.begin_sends(shards, recv)
        for s, sched, seg in zip(shards, scheds, segs):
            if mode == "serial":
                rx.segment_copy(ov.group_sort(s, tile, 0, 8), seg, recv)
            elif mode == "plain":
                ov.group_sort_send_plain(s, tile, 0, 8, sched, recv)
            else:
                ov.group_sort_send(s, tile, 0, 8, sched, recv)
        rx.end_sends(shards, recv)
    return run


def check_segment_copy(dev, rng, ranks, n_small: int, n_big: int) -> int:
    """B6 byte for byte against segment_copy_plain: for each rank count, the
    schedules that real counts give (through the port's digit sort and
    send_matrix), every sender; then 4 ranks of n_big keys.  Returns the
    number of launches compared."""
    from gpu_radix_sort_tpu_torch.ops.boundaries import digit_counts_sorted
    from gpu_radix_sort_tpu_torch.ops.radix_sort import sort_by_digits
    from gpu_radix_sort_tpu_torch.parallel import rdma_exchange as rx

    def one(a: np.ndarray, P: int, what: str) -> int:
        x = torch.from_numpy(a).to(dev).view(P, -1)
        n_local = x.shape[1]
        shards = [sort_by_digits(x[i].contiguous(), 8, 8) for i in range(P)]
        counts = torch.stack([digit_counts_sorted(s, 8, 8) for s in shards])
        M = rx.send_matrix(counts, n_local)
        for i, s in enumerate(shards):
            segs = rx.segments(M, i)
            got = [torch.zeros(n_local, dtype=torch.uint32, device=dev) for _ in range(P)]
            want = [torch.zeros(n_local, dtype=torch.uint32, device=dev) for _ in range(P)]
            rx.segment_copy(s, segs, got)
            rx.segment_copy_plain(s, segs, want)
            same_bytes(got, want, f"segment_copy {what} sender {i}")
        return P

    cases = 0
    for P in ranks:
        for name, a in exchange_inputs(rng, n_small * P):
            cases += one(a, P, f"P={P} n_local={n_small} {name}")
    cases += one(rng.integers(0, 1 << 32, 4 * n_big, dtype=np.uint32), 4,
                 f"P=4 n_local={n_big} uniform")
    return cases


def check_segment_alignment(devs: list, rng, n_local: int) -> int:
    """B6 byte for byte against segment_copy_plain at every word offset of
    the source and of the receivers past a 16-byte boundary (4 x 4, the
    receivers' offsets staggered by rank), P = len(devs) ranks with rank c's
    buffers on devs[c], schedules from uniform keys.  Returns the number of
    launches compared."""
    from gpu_radix_sort_tpu_torch.ops.boundaries import digit_counts_sorted
    from gpu_radix_sort_tpu_torch.ops.radix_sort import sort_by_digits
    from gpu_radix_sort_tpu_torch.parallel import rdma_exchange as rx

    P = len(devs)
    x = torch.from_numpy(rng.integers(0, 1 << 32, P * n_local, dtype=np.uint32)).view(P, -1)
    shards = [sort_by_digits(x[i].contiguous(), 8, 8) for i in range(P)]  # on the CPU
    M = rx.send_matrix(torch.stack([digit_counts_sorted(s, 8, 8) for s in shards]), n_local)

    def placed(a: torch.Tensor, dev, shift: int) -> torch.Tensor:
        """a on dev, starting ``shift`` keys past a 16-byte boundary."""
        pad = np.zeros(shift, np.uint32)
        return torch.from_numpy(np.concatenate([pad, a.numpy()])).to(dev)[shift:]

    cases = 0
    for src_shift in range(4):
        for dst_shift in range(4):
            for i in range(P):
                segs = rx.segments(M, i)
                want = [torch.zeros(n_local, dtype=torch.uint32) for _ in range(P)]
                rx.segment_copy_plain(shards[i], segs, want)
                src = placed(shards[i], devs[i], src_shift)
                got = [placed(torch.zeros(n_local, dtype=torch.uint32), devs[c],
                              (dst_shift + c) % 4) for c in range(P)]
                rx.begin_sends([src], got)
                rx.segment_copy(src, segs.to(devs[i]), got)
                rx.end_sends([src], got)
                same_bytes(got, want, f"segment_copy P={P} sender {i} source shift "
                                      f"{src_shift} receiver shift {dst_shift}")
                cases += 1
    return cases


def check_group_sort_send(dev, rng, tiles, widths, groups, n_big: int) -> int:
    """B7 byte for byte against its plain version on 4 ranks, in both modes
    (send, and sort-only into a staging buffer); the serial round equal to
    the overlapped one; then one round of n_big keys a rank.  Returns the
    number of launches compared."""
    from gpu_radix_sort_tpu_torch.parallel import rdma_overlap as ov
    from gpu_radix_sort_tpu_torch.parallel.mesh import all_gather, key_mesh, shard

    P = 4
    mesh = key_mesh([dev] * P)

    def one(a: np.ndarray, tile: int, w: int, what: str) -> int:
        shards = shard(torch.from_numpy(a).to(dev), mesh)
        n_local = shards[0].numel()
        hists = all_gather([ov._group_hist(s, 8, w, tile) for s in shards])
        start, dst_start = ov.overlap_schedule(hists[0], n_local)
        got = [torch.zeros(n_local, dtype=torch.uint32, device=dev) for _ in range(P)]
        want = [torch.zeros(n_local, dtype=torch.uint32, device=dev) for _ in range(P)]
        for i, s in enumerate(shards):
            sched = torch.stack([start[i], dst_start[i]])
            ov.group_sort_send(s, tile, 8, w, sched, got)
            ov.group_sort_send_plain(s, tile, 8, w, sched, want)
            same_bytes([ov.group_sort(s, tile, 8, w)], [ov.sort_groups_plain(s, tile, 8, w)],
                       f"group_sort {what} rank {i}")
        same_bytes(got, want, f"group_sort_send {what}")
        return 2 * P

    cases = 0
    for tile in tiles:
        for w in widths:
            for G in groups:
                for name, a in exchange_inputs(rng, P * G * tile):
                    if name != "presorted":
                        cases += one(a, tile, w, f"tile={tile} width={w} G={G} {name}")
    a = rng.integers(0, 1 << 32, P * 64 * tiles[-1], dtype=np.uint32)
    shards = shard(torch.from_numpy(a).to(dev), mesh)
    serial, _ = ov.exchange_round_rdma_overlapped(shards, 8, 8, tile=tiles[-1], serial=True)
    overlapped, _ = ov.exchange_round_rdma_overlapped(shards, 8, 8, tile=tiles[-1])
    same_bytes(overlapped, serial, "rdma_overlap round, overlapped vs serial")
    cases += one(rng.integers(0, 1 << 32, P * n_big, dtype=np.uint32), ov.MAX_TILE, 8,
                 f"tile={ov.MAX_TILE} width=8 n_local={n_big}")
    return cases


def mesh_path(dev, rng, card: str, part: torch.Tensor, part_np: np.ndarray,
              b6_info: dict, b7_info: dict, want: np.ndarray) -> dict:
    """Steps 8-10: the exchange kernels, the mesh LSD sort of ``part`` (256Mi
    PCG32 keys on the card, ``want`` their np.sort) and their times.
    Returns the results for the JSON line (``b6_info`` and ``b7_info``, the
    kernels' ptxas reports and B7's occupancy, go into their rows)."""
    import gpu_radix_sort_tpu_torch as port
    from gpu_radix_sort_tpu_torch.ops import binning as bn
    from gpu_radix_sort_tpu_torch.ops import block_sort as bs
    from gpu_radix_sort_tpu_torch.ops import digit_sort as ds
    from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
    from gpu_radix_sort_tpu_torch.ops import onesweep as osw
    from gpu_radix_sort_tpu_torch.ops import radix_sort as rs
    from gpu_radix_sort_tpu_torch.ops import single_block as sb
    from gpu_radix_sort_tpu_torch.ops.bits import sortable_digits
    from gpu_radix_sort_tpu_torch.ops.boundaries import digit_counts
    from gpu_radix_sort_tpu_torch.parallel import distributed as dist
    from gpu_radix_sort_tpu_torch.parallel import rdma_exchange as rx
    from gpu_radix_sort_tpu_torch.parallel import rdma_overlap as ov
    from gpu_radix_sort_tpu_torch.parallel.mesh import key_mesh, shard
    from gpu_radix_sort_tpu_torch.utils import timers

    n_rank = N_MESH // MESH_RANKS
    t0 = time.perf_counter()
    b6_cases = check_segment_copy(dev, rng, (1, 2, 4, 8), 1000, n_rank)
    n_align = 3 * rx.COPY_CHUNK + 5
    b6_align = sum(check_segment_alignment([dev] * P, rng, n_align) for P in (1, MESH_RANKS))
    log(f"segment_copy: {b6_cases} launches equal to the plain version byte for "
        f"byte (P in (1, 2, 4, 8), n_local 1000, uniform/duplicate/presorted/"
        f"skewed/equal; P=4 at n_local={n_rank}); {b6_align} more at every source "
        f"x receiver word offset past a 16-byte boundary (P 1 and {MESH_RANKS}, "
        f"n_local={n_align}) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    b7_cases = check_group_sort_send(dev, rng, (1024, 2048, ov.MAX_TILE), (1, 4, 8),
                                     (1, 3, 64), n_rank)
    log(f"group_sort_send: {b7_cases} launches (send and sort-only) equal to the "
        f"plain version byte for byte (tiles 1024/2048/{ov.MAX_TILE}, widths 1/4/8, "
        f"G 1/3/64, uniform/duplicate/skewed/equal, 4 ranks; serial round == "
        f"overlapped round; n_local={n_rank}) in {time.perf_counter() - t0:.1f} s")

    counters = {"segment_copy": rx, "group_sort_send": ov, "onesweep": osw,
                "block_sort": bs, "merge_level": ms, "digit_sort": ds, "binning": bn,
                "single_block_sort": sb}

    def zero() -> None:
        for mod in counters.values():
            mod.launches = 0

    def read() -> dict:
        return {name: mod.launches for name, mod in counters.items()}

    def exact(out: torch.Tensor, want: np.ndarray, what: str) -> None:
        if not np.array_equal(out.cpu().numpy(), want):
            fail(f"{what} differs from np.sort")

    # -- main path three: sort_distributed(rdma) on key_mesh() ---------------
    mesh1 = key_mesh()
    P1 = mesh1.size
    nsteps = 32 // 8
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero()
    t0 = time.perf_counter()
    out = port.sort_distributed(part, mesh=mesh1, width=8, exchange="rdma")
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    main_launches = read()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    expect = {**dict.fromkeys(counters, 0), "segment_copy": nsteps * P1,
              **full_sort_launches(N_MESH // P1, (nsteps + 1) * P1)}
    log(f"main path: sort_distributed(width=8, exchange='rdma') of {N_MESH} PCG32 keys "
        f"on key_mesh() ({P1} rank), launches {main_launches}; first call "
        f"{first_ms:.1f} ms by host clock; peak device memory {peak:.0f} MiB above "
        f"the {N_MESH * 4 / 2**20:.0f} MiB of keys")
    if main_launches != expect:
        fail(f"main path launches {main_launches}, expected {expect}")
    exact(out, want, f"sort_distributed rdma of {N_MESH} keys on key_mesh()")
    del out
    log("main path: exact against np.sort")

    # -- four ranks on one card ------------------------------------------------
    mesh4 = key_mesh([dev] * MESH_RANKS)
    four = {
        "rdma": {**dict.fromkeys(counters, 0), "segment_copy": nsteps * MESH_RANKS,
                 **full_sort_launches(n_rank, (nsteps + 1) * MESH_RANKS)},
        "rdma_overlap": {**dict.fromkeys(counters, 0), "group_sort_send": nsteps * MESH_RANKS,
                         "binning": nsteps * MESH_RANKS * 2},
    }
    four_launches = {}
    for exchange, expect in four.items():
        zero()
        t0 = time.perf_counter()
        out = port.sort_distributed(part, mesh=mesh4, width=8, exchange=exchange)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        four_launches[exchange] = read()
        log(f"four ranks: sort_distributed(width=8, exchange={exchange!r}) of {N_MESH} "
            f"keys, {MESH_RANKS} ranks on {dev}, launches {four_launches[exchange]}; "
            f"first call {first_ms:.1f} ms by host clock")
        if four_launches[exchange] != expect:
            fail(f"four-rank {exchange} launches {four_launches[exchange]}, expected {expect}")
        exact(out, want, f"four-rank sort_distributed {exchange}")
        del out
    log("four ranks: rdma and rdma_overlap exact against np.sort")

    n_mid = 1 << 24
    mid, mid_want = part[:n_mid], np.sort(part_np[:n_mid])
    for exchange, width in (("rdma", 16), ("alltoall", 8), ("gather", 8)):
        exact(port.sort_distributed(mid, mesh=mesh4, width=width, exchange=exchange),
              mid_want, f"four-rank {exchange} width {width} at {n_mid}")
    equal = torch.from_numpy(np.full(n_mid, 0x9E3779B9, np.uint32)).to(dev)
    for exchange in ("rdma", "rdma_overlap"):
        got = port.sort_distributed(equal, mesh=mesh4, exchange=exchange)
        exact(got, np.full(n_mid, 0x9E3779B9, np.uint32), f"all-equal keys via {exchange}")
    n_typed = 1 << 22
    ints = part_np[:n_typed].view(np.int32)
    got = port.sort_distributed(torch.from_numpy(ints).to(dev), mesh=mesh4, exchange="rdma")
    if not np.array_equal(got.cpu().numpy(), np.sort(ints)):
        fail("int32 keys via rdma differ from np.sort")
    floats = part_np[n_typed:2 * n_typed].view(np.float32)
    got = port.sort_distributed(torch.from_numpy(floats).to(dev), mesh=mesh4, exchange="rdma")
    if not np.array_equal(total_order_np(got.cpu().numpy()), np.sort(total_order_np(floats))):
        fail("float32 keys via rdma differ from the numpy totalOrder sort")
    del mid, equal, got
    log(f"four ranks: rdma width 16, alltoall and gather at {n_mid} exact; all-equal "
        f"keys via rdma and rdma_overlap exact; int32 and float32 via rdma at "
        f"{n_typed} exact")

    # -- times -------------------------------------------------------------------
    shards1 = shard(part, mesh1)
    fn1 = dist.build_distributed_sort(mesh1, N_MESH // P1, width=8, exchange="rdma")
    shards4 = shard(part, mesh4)
    fn4 = dist.build_distributed_sort(mesh4, n_rank, width=8, exchange="rdma")
    fn4o = dist.build_distributed_sort(mesh4, n_rank, width=8, exchange="rdma_overlap")
    res = {
        "mesh_rdma_ms": timers.time_cuda(lambda: fn1(shards1)),
        "sort_full_256Mi_ms": timers.time_cuda(lambda: rs.sort_full(part)),
        "torch_sort_256Mi_ms": timers.time_cuda(lambda: rs.sort_full(part, strategy="torch")),
        "mesh4_rdma_ms": timers.time_cuda(lambda: fn4(shards4)),
        "mesh4_rdma_overlap_ms": timers.time_cuda(lambda: fn4o(shards4)),
    }
    log(f"time [{card}]: sort_distributed rdma, {P1} rank, {N_MESH} keys "
        f"{res['mesh_rdma_ms']:.3f} ms ({N_MESH / (res['mesh_rdma_ms'] * 1e-3):.4g} "
        f"keys/s); sort_full of the same keys {res['sort_full_256Mi_ms']:.3f} ms; "
        f"torch.sort (strategy='torch') {res['torch_sort_256Mi_ms']:.3f} ms")
    log(f"time [{card}]: {MESH_RANKS} ranks on one card: rdma {res['mesh4_rdma_ms']:.3f} "
        f"ms; rdma_overlap {res['mesh4_rdma_overlap_ms']:.3f} ms")
    res["launches_one_rank"] = main_launches
    res["tile_pass_256Mi_ms"] = timers.time_cuda(
        lambda: bs.block_sort(part, bs.TILE, alternate=True))
    runs = bs.block_sort(part, bs.TILE, alternate=True)
    res["merge_level_256Mi_ms"] = timers.time_cuda(lambda: ms.merge_level(runs, bs.TILE))
    del runs
    log(f"time [{card}]: at {N_MESH} keys, one tile pass (tile {bs.TILE}) "
        f"{res['tile_pass_256Mi_ms']:.3f} ms and one merge level (L={bs.TILE}) "
        f"{res['merge_level_256Mi_ms']:.3f} ms; bound {bound(8 * N_MESH, 0)[0]:.3f} ms each")

    # B6: one launch over the whole shard (one rank: one segment of 256Mi),
    # into a receiver aligned to 16 bytes and into one shifted by a key,
    # beside copy_ of the same bytes, in turns; 10 calls back to back, as the
    # wrapper's host work would show in a single call
    segs1 = rx.segments(rx.send_matrix(digit_counts(part, 0, 8)[None], N_MESH), 0)
    recv1 = [torch.empty_like(part)]
    recv1s = [torch.empty(N_MESH + 4, dtype=torch.uint32, device=dev)[1:N_MESH + 1]]
    turns = {"copy": lambda: recv1[0].copy_(part),
             "b6": lambda: rx.segment_copy(part, segs1, recv1),
             "b6_shifted": lambda: rx.segment_copy(part, segs1, recv1s),
             "copy_shifted": lambda: recv1s[0].copy_(part)}
    order = list(turns) + list(turns)[::-1]
    times = {name: [] for name in turns}
    for name in order:
        times[name].append(back_to_back_ms(turns[name]))
    ms_copy, ms_b6, ms_b6_shift, ms_copy_shift = (sum(v) / len(v) for v in times.values())
    ms_b6_call = timers.time_cuda(turns["b6"])
    ms_b6_plain = timers.time_cuda(lambda: rx.segment_copy_plain(part, segs1, recv1))
    b6_bound = bound(8 * N_MESH, 0)
    # ... and one round's four launches on four ranks (4 segments each)
    ms_b6_round = timers.time_cuda(b6_round(shards4))
    log(f"time [{card}]: segment_copy one launch of {N_MESH} keys {ms_b6:.3f} ms "
        f"({8 * N_MESH / (ms_b6 * 1e-3) / 1e9:.4g} GB/s moved; bound {b6_bound[0]:.3f} "
        f"ms), into a receiver shifted by one key {ms_b6_shift:.3f} ms; copy_ of the "
        f"same bytes {ms_copy:.3f} ms, shifted {ms_copy_shift:.3f} ms (10 calls back "
        f"to back; each the mean of two medians, in turns: "
        f"{ {k: [round(x, 4) for x in v] for k, v in times.items()} }); a single "
        f"call by CUDA events {ms_b6_call:.3f} ms; plain {ms_b6_plain:.3f} ms; a "
        f"{MESH_RANKS}-rank round (4 launches, 4 segments each) {ms_b6_round:.3f} ms")
    del recv1, recv1s

    # B7: one round on four ranks, overlapped and serial
    tile = ov.pick_tile(n_rank)
    rows = sortable_digits(part.view(-1, tile), 0, 8)
    ms_b7 = timers.time_cuda(b7_round(shards4, "send"))
    ms_b7_serial = timers.time_cuda(b7_round(shards4, "serial"))
    ms_b7_plain = timers.time_cuda(b7_round(shards4, "plain"))
    ms_b7_lib = timers.time_cuda(lambda: torch.sort(rows, dim=1, stable=True))
    ms_b7_sort = timers.time_cuda(lambda: [ov.group_sort(s, tile, 0, 8) for s in shards4])
    b7_bound = bound(8 * N_MESH, 0)  # a read and a write a key; no network
    log(f"time [{card}]: group_sort_send, one round of {MESH_RANKS} launches over "
        f"{N_MESH} keys (tile {tile}, width 8): overlapped {ms_b7:.3f} ms; serial "
        f"(sort-only launches + segment_copy) {ms_b7_serial:.3f} ms; sort-only "
        f"launches alone {ms_b7_sort:.3f} ms; plain {ms_b7_plain:.3f} ms; stable "
        f"torch.sort of the (G, tile) digit rows {ms_b7_lib:.3f} ms; bound "
        f"{b7_bound[0]:.3f} ms ({b7_bound[1]})")
    del rows

    for what, fn in ((f"rdma, {P1} rank", lambda: fn1(shards1)),
                     (f"rdma_overlap, {MESH_RANKS} ranks on {dev}", lambda: fn4o(shards4))):
        log_profile(card, f"sort_distributed {what}, {N_MESH} keys", fn, top=10)

    res["kernels"] = [
        ("segment_copy", "exchange.cu", "gpu_radix_sort_tpu/parallel/rdma_exchange.py:60",
         main_launches["segment_copy"], 0, ms_b6, ms_b6_plain, b6_bound, ms_copy,
         {"round4_ms": ms_b6_round, "launches_four_ranks": four_launches["rdma"]["segment_copy"],
          "timed": "10 calls back to back", "single_call_ms": ms_b6_call,
          "shifted_ms": ms_b6_shift, "copy_shifted_ms": ms_copy_shift, "turns": times,
          **b6_info}),
        ("group_sort_send", "exchange.cu", "gpu_radix_sort_tpu/parallel/rdma_overlap.py:116",
         four_launches["rdma_overlap"]["group_sort_send"], 0, ms_b7, ms_b7_plain, b7_bound,
         ms_b7_lib, {"serial_ms": ms_b7_serial, "sort_only_ms": ms_b7_sort, "tile": tile,
                     **b7_info}),
    ]
    res["n_mesh"] = N_MESH
    return res


def kv_table_path(dev, card: str, part: torch.Tensor, part_np: np.ndarray,
                  zipf_keys=None, keep: dict | None = None) -> dict:
    """The key-value, 64-bit and table paths at the JAX harness's sizes
    (gpu_radix_sort_tpu/bench/harness.py:125-207): each exact against a
    numpy oracle, with the launch counts set to 0 just before and read just
    after, its peak device memory, its time and its "torch" route's (median
    of 10 by CUDA events), and profiles of two of them.  ``part`` holds the
    256Mi PCG32 keys of the partial path (on the card), ``part_np`` the same
    on the host; ``zipf_keys``, a future of the Zipf keys made beside the
    run (:func:`start_zipf_keys`), or None to make them here.  ``keep``, a
    dict, receives the oracles the sample path reuses (see
    :func:`sample_path`).  Returns the results for the JSON line."""
    import gpu_radix_sort_tpu_torch as port
    from gpu_radix_sort_tpu_torch.ops import binning as bn
    from gpu_radix_sort_tpu_torch.ops import block_sort as bs
    from gpu_radix_sort_tpu_torch.ops import digit_sort as ds
    from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
    from gpu_radix_sort_tpu_torch.ops import onesweep as osw
    from gpu_radix_sort_tpu_torch.ops import single_block as sb
    from gpu_radix_sort_tpu_torch.ops import table
    from gpu_radix_sort_tpu_torch.ops.bits import digits64, decode_ordered64, encode_ordered64
    from gpu_radix_sort_tpu_torch.utils import checks, keygen, timers

    counters = {"onesweep": osw, "block_sort": bs, "merge_level": ms, "digit_sort": ds,
                "binning": bn, "single_block_sort": sb}
    none = dict.fromkeys(counters, 0)
    res = {"launches": {}, "peak_mib": {}, "ms": {}, "torch_ms": {}, "card": card}
    keep = {} if keep is None else keep

    def run(name: str, fn, expect: dict):
        """fn() with the counts set to 0 just before and read just after;
        fails unless they are ``expect`` (kernels not named: 0)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for mod in counters.values():
            mod.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: mod.launches for k, mod in counters.items()}
        want = {**none, **expect}
        if got != want:
            fail(f"{name}: launches {got}, expected {want}")
        res["launches"][name] = {k: v for k, v in got.items() if v}
        res["peak_mib"][name] = (torch.cuda.max_memory_allocated() - held) / 2**20
        return out

    def same(got: torch.Tensor, want: np.ndarray, what: str) -> None:
        got = got.cpu().numpy()
        if got.dtype != want.dtype or got.shape != want.shape or not np.array_equal(
                got.view(np.uint8), np.ascontiguousarray(want).view(np.uint8)):
            fail(f"{what} differs from the numpy oracle")

    def timed(name: str, fn, torch_fn=None) -> None:
        res["ms"][name] = timers.time_cuda(fn)
        if torch_fn is not None:
            res["torch_ms"][name] = timers.time_cuda(torch_fn)
        log(f"time [{card}]: {name} {res['ms'][name]:.3f} ms; its torch route "
            f"{res['torch_ms'].get(name, float('nan')):.3f} ms; launches "
            f"{res['launches'].get(name)}; peak device memory "
            f"{res['peak_mib'].get(name, float('nan')):.0f} MiB above its inputs")

    def torch_default(fn):
        """fn with the port's default strategy set to "torch"."""
        def call():
            port.set_default_strategy("torch")
            try:
                return fn()
            finally:
                port.set_default_strategy("auto")
        return call

    passes32 = 32 // bn.PASS_WIDTH
    t0 = time.perf_counter()

    # -- sort_key_value of 128Mi PCG32 keys (kv_sort_u32_p8B / p64B) --------
    n = part.numel()
    n_kv = n // 2
    keys, keys_np = part[:n_kv], part_np[:n_kv]
    order = stable_order_u32(keys_np)  # the oracle of both payloads
    payload8_np = keygen.generate_payloads(n_kv, payload_bytes=8)
    payload8 = torch.from_numpy(payload8_np).to(dev)
    kv_expect = {"binning": 2 * passes32}  # keys and the row index a pass
    sk, sv = run("sort_key_value p8B", lambda: port.sort_key_value(keys, payload8), kv_expect)
    same(sk, keys_np[order], "sort_key_value p8B keys")
    same(sv, take_rows(payload8_np, order), "sort_key_value p8B payload")
    del sk, sv
    timed("sort_key_value p8B", lambda: port.sort_key_value(keys, payload8),
          lambda: port.sort_key_value(keys, payload8, strategy="torch"))
    payload64_np = keygen.generate_payloads(n_kv, payload_bytes=64)
    payload64 = torch.from_numpy(payload64_np).to(dev)
    sk, sv = run("sort_key_value p64B", lambda: port.sort_key_value(keys, payload64), kv_expect)
    same(sk, keys_np[order], "sort_key_value p64B keys")
    same(sv, take_rows(payload64_np, order), "sort_key_value p64B payload")
    del sk, sv, payload64_np
    timed("sort_key_value p64B", lambda: port.sort_key_value(keys, payload64),
          lambda: port.sort_key_value(keys, payload64, strategy="torch"))
    res["p64B_bound_ms"] = bound(2 * n_kv * (4 + 64), 0)[0]  # keys and rows, read and written
    log_profile(card, f"sort_key_value p64B of {n_kv} rows",
                lambda: port.sort_key_value(keys, payload64))
    del payload64
    f32 = keys.view(torch.float32)
    order_f = stable_order_u32(total_order_np(keys_np.view(np.float32)))
    sk, sv = run("sort_key_value f32 keys p8B", lambda: port.sort_key_value(f32, payload8),
                 kv_expect)
    same(sk, keys_np.view(np.float32)[order_f], "sort_key_value f32 keys")
    same(sv, take_rows(payload8_np, order_f), "sort_key_value f32 payload")
    keep["kv8"] = (order, payload8_np)
    del sk, sv, order_f, order
    timed("sort_key_value f32 keys p8B", lambda: port.sort_key_value(f32, payload8),
          lambda: port.sort_key_value(f32, payload8, strategy="torch"))
    del payload8
    log(f"kv path: sort_key_value of {n_kv} PCG32 keys with 8- and 64-byte payloads "
        f"and as float32 keys, exact against numpy's stable order "
        f"({time.perf_counter() - t0:.1f} s so far)")

    # -- sort_key_value_by_digits at 256Mi, w8, (n, 4) uint32 lanes ----------
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    lanes = torch.stack([idx, idx ^ 0x5BD1E995, part.view(torch.int32),
                         ~part.view(torch.int32)], dim=1).view(torch.uint32)
    del idx
    sk, sl = run("sort_key_value_by_digits w8 lanes4",
                 lambda: port.sort_key_value_by_digits(part, lanes, 0, 8),
                 {"binning": 2 * 2})
    order = np.argsort((part_np & np.uint32(0xFF)).astype(np.uint8), kind="stable")
    same(sk, part_np[order], "sort_key_value_by_digits w8 keys")
    o32 = order.astype(np.uint32)
    want = np.stack([o32, o32 ^ np.uint32(0x5BD1E995), part_np[order], ~part_np[order]], axis=1)
    same(sl, want, "sort_key_value_by_digits w8 lanes")
    del sk, sl, want, o32, order
    timed("sort_key_value_by_digits w8 lanes4",
          lambda: port.sort_key_value_by_digits(part, lanes, 0, 8),
          lambda: port.sort_key_value_by_digits(part, lanes, 0, 8, strategy="torch"))
    n_pass = 1 << 20
    sk, sl = bn.binning_pass_kv(part[:n_pass], lanes[:n_pass], 0, 8)
    order = np.argsort((part_np[:n_pass] & np.uint32(0xFF)).astype(np.uint8), kind="stable")
    same(sk, part_np[:n_pass][order], "binning_pass_kv keys")
    same(sl, lanes[:n_pass].cpu().numpy()[order], "binning_pass_kv lanes")
    del lanes, sk, sl, order
    log(f"kv path: sort_key_value_by_digits(0, 8) of {n} keys with (n, 4) uint32 "
        f"lanes, and binning_pass_kv at {n_pass}, exact")

    # -- 64-bit keys: 256Mi uint64 from default_rng(64) ----------------------
    torch.cuda.empty_cache()
    u64_np = np.random.default_rng(64).integers(0, 1 << 64, n, dtype=np.uint64)
    u64 = torch.from_numpy(u64_np).to(dev)
    out = run("sort_full_u64", lambda: port.sort_full_u64(u64), {})
    want = np.sort(u64_np)
    keep["u64"] = (u64_np, want)
    same(out, want, "sort_full_u64")
    del out
    timed("sort_full_u64", lambda: port.sort_full_u64(u64))
    for offset, width in ((0, 8), (28, 16)):
        d = ((u64_np >> np.uint64(offset)) & np.uint64((1 << width) - 1))
        d = d.astype(np.uint8 if width <= 8 else np.uint16)
        order = np.argsort(d, kind="stable")
        sd = d[order].astype(np.uint32)
        want_b = checks.boundaries_oracle(sd, 0, width)
        want_c = np.bincount(d, minlength=1 << width).astype(np.int32)
        name = f"sort_partial_u64 ({offset}, {width}) stable"
        passes = -(-width // bn.PASS_WIDTH)
        out, b = run(name, lambda: port.sort_partial_u64(u64, offset, width),
                     {"binning": 3 * passes})  # the digit and the two words
        same(out, u64_np[order], name)
        same(b, want_b, f"{name} boundaries")
        del out, b
        out, c = port.sort_partial_counts_u64(u64, offset, width)
        same(out, u64_np[order], f"{name} (counts)")
        same(c, want_c, f"{name} counts")
        del out, c, order
        def partial_torch(offset=offset, width=width):
            s = encode_ordered64(u64)
            d = digits64(s, offset, width).view(torch.int32)
            o = torch.sort(d.to(torch.uint8) if width <= 8 else d, stable=True).indices
            return decode_ordered64(s[o], torch.uint64)

        timed(name, lambda: port.sort_partial_u64(u64, offset, width), partial_torch)
        name = f"sort_partial_u64 ({offset}, {width}) unstable"
        r = (offset + width) % 64
        rot = np.sort((u64_np >> np.uint64(r)) | (u64_np << np.uint64(64 - r)))
        want = (rot << np.uint64(r)) | (rot >> np.uint64(64 - r))
        out, c = run(name, lambda: port.sort_partial_counts_u64(u64, offset, width, stable=False), {})
        same(out, want, name)
        same(c, want_c, f"{name} counts")
        out, b = port.sort_partial_u64(u64, offset, width, stable=False)
        same(b, want_b, f"{name} boundaries")
        del out, b, c, rot, want
        timed(name, lambda: port.sort_partial_u64(u64, offset, width, stable=False))
    log_profile(card, f"sort_partial_u64(28, 16) stable of {n} keys",
                lambda: port.sort_partial_u64(u64, 28, 16))
    log(f"u64 path: sort_full_u64, sort_partial_u64 and sort_partial_counts_u64 at "
        f"(0, 8) and (28, 16), stable and not, of {n} uint64 keys, exact "
        f"({time.perf_counter() - t0:.1f} s so far)")

    keys64, keys64_np = u64[:n_kv], u64_np[:n_kv]
    payload8 = torch.from_numpy(payload8_np).to(dev)
    s64 = np.sort(keys64_np)
    if np.all(s64[1:] != s64[:-1]):  # distinct keys: every order is the stable one
        order = np.argsort(keys64_np)
    else:
        order = np.argsort(keys64_np, kind="stable")
    del s64
    name = "sort_key_value_u64 p8B"
    sk, sv = run(name, lambda: port.sort_key_value_u64(keys64, payload8),
                 {"binning": 2 * passes32 * 3})  # two words, a row index
    same(sk, keys64_np[order], f"{name} keys")
    same(sv, take_rows(payload8_np, order), f"{name} payload")
    keep["kv64_order"] = order
    del sk, sv, order

    def kv64_torch():
        o = torch.sort(encode_ordered64(keys64), stable=True).indices
        return keys64.view(torch.int64)[o], payload8[o]

    timed(name, lambda: port.sort_key_value_u64(keys64, payload8), kv64_torch)
    del u64, keys64, payload8
    n_typed = 1 << 20
    rng = np.random.default_rng(65)
    i64 = rng.integers(-(1 << 63), (1 << 63) - 1, n_typed, dtype=np.int64)
    i64[::5] = i64[3]
    f64 = rng.standard_normal(n_typed) * 1e6
    f64[:8] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 0.0, -0.0]
    f64[8::97] = -0.0
    f64[9::89] = np.nan
    for typed in (i64, f64):
        x = torch.from_numpy(typed).to(dev)
        enc = total_order_np64(typed)
        order = np.argsort(enc, kind="stable")
        what = f"{typed.dtype} keys"
        same(port.sort_full_u64(x), typed[order], f"sort_full_u64 of {what}")
        vals = np.arange(n_typed, dtype=np.uint32)
        sk, sv = run(f"sort_key_value_u64 {typed.dtype}",
                     lambda: port.sort_key_value_u64(x, torch.from_numpy(vals).to(dev)),
                     {"binning": 2 * passes32 * 3})  # two words, the column
        same(sk, typed[order], f"sort_key_value_u64 of {what}")
        same(sv, vals[order], f"sort_key_value_u64 payload of {what}")
        d = ((enc >> np.uint64(56)) & np.uint64(0xFF)).astype(np.uint8)
        o = np.argsort(d, kind="stable")
        out, c = port.sort_partial_counts_u64(x, 56, 8)
        same(out, typed[o], f"sort_partial_u64(56, 8) of {what}")
        same(c, np.bincount(d, minlength=256).astype(np.int32), f"counts of {what}")
    log(f"u64 path: sort_key_value_u64 of {n_kv} keys with an 8-byte payload; "
        f"int64 and float64 (NaNs, +-0.0, +-inf) at {n_typed}: sort_full_u64, "
        f"sort_key_value_u64, sort_partial_counts_u64(56, 8), exact")
    del payload8_np, u64_np, keys64_np
    torch.cuda.empty_cache()

    # -- tables ---------------------------------------------------------------
    nparts = 256
    ids = table.hash_partition_ids(part, nparts)
    ids_np = hash_np(part_np) >> np.uint32(24)
    same(ids, ids_np, "hash_partition_ids")
    order = np.argsort(ids_np.astype(np.uint8), kind="stable")
    name = "partition_by_ids 256"
    got, counts = run(name, lambda: table.partition_by_ids(part, ids, nparts), {"binning": 2 * 2})
    same(got, part_np[order], name)
    same(counts, np.bincount(ids_np, minlength=nparts).astype(np.int32), f"{name} counts")
    del got, counts, order, ids_np
    timed(name, lambda: table.partition_by_ids(part, ids, nparts),
          torch_default(lambda: table.partition_by_ids(part, ids, nparts)))
    del ids
    lo, hi = 1 << 30, 3 << 30
    name = "filter_range half"
    got, count = run(name, lambda: table.filter_range(part, lo, hi), {})
    want = part_np[(part_np >= lo) & (part_np < hi)]
    if int(count) != want.size:
        fail(f"{name}: count {int(count)}, expected {want.size}")
    same(got[:want.size], want, name)
    del got, want
    timed(name, lambda: table.filter_range(part, lo, hi))
    log(f"table path: hash_partition_ids and partition_by_ids of {n} PCG32 keys "
        f"into {nparts} parts, filter_range [2^30, 3 * 2^30), exact")

    zipf_np = (zipf_keys.result() if zipf_keys is not None
               else keygen.generate_zipf_keys(n, alpha=1.1))
    zipf = torch.from_numpy(zipf_np).to(dev)
    order = stable_order_u32(zipf_np)
    zs = zipf_np[order]
    keep["zipf"] = (zipf_np, zs)
    starts = run_starts(zs)
    uniq_np = zs[starts]
    name = "group_aggregate count zipf"
    uniq, agg, ng = run(name, lambda: table.group_aggregate(zipf, None, "count"),
                        full_sort_launches(n))
    g = int(ng)
    if g != starts.size:
        fail(f"{name}: {g} groups, expected {starts.size}")
    same(uniq[:g], uniq_np, f"{name} keys")
    same(agg[:g], np.diff(np.append(starts, n)).astype(np.uint32), name)
    del uniq, agg
    timed(name, lambda: table.group_aggregate(zipf, None, "count"),
          lambda: torch.unique(zipf.view(torch.int32), return_counts=True))
    vals = part  # uint32 values: the PCG32 keys
    name = "group_aggregate u32 sum zipf"
    uniq, agg, ng = run(name, lambda: table.group_aggregate(zipf, vals, "sum"),
                        {"binning": 2 * passes32})
    want = (np.add.reduceat(part_np[order].astype(np.uint64), starts) & np.uint64(0xFFFFFFFF))
    same(uniq[:g], uniq_np, f"{name} keys")
    same(agg[:g], want.astype(np.uint32), name)
    del uniq, agg, want
    timed(name, lambda: table.group_aggregate(zipf, vals, "sum"),
          torch_default(lambda: table.group_aggregate(zipf, vals, "sum")))
    fvals_np = (part_np >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)
    fvals = torch.from_numpy(fvals_np).to(dev)
    name = "group_aggregate f32 sum zipf"
    _, agg, _ = run(name, lambda: table.group_aggregate(zipf, fvals, "sum"),
                    {"binning": 2 * passes32})
    _, again, _ = table.group_aggregate(zipf, fvals, "sum")
    if not torch.equal(agg.view(torch.int32), again.view(torch.int32)):
        fail(f"{name}: two calls gave different bytes")
    want = np.add.reduceat(fvals_np[order].astype(np.float64), starts)
    got = agg[:g].cpu().numpy().astype(np.float64)
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
    if rel > 1e-5 or agg[g:].any():
        fail(f"{name}: relative error {rel} against float64 sums (limit 1e-5)")
    res["f32_sum_max_rel_err"] = rel
    del agg, again, want, got
    timed(name, lambda: table.group_aggregate(zipf, fvals, "sum"))
    log(f"table path: group_aggregate count and uint32 sum over {n} Zipf(1.1) keys "
        f"({g} groups, the largest {int(np.diff(np.append(starts, n)).max())} rows) "
        f"exact; float32 sum the same bytes on two calls, within {rel:.3g} of "
        f"float64 sums (limit 1e-5) ({time.perf_counter() - t0:.1f} s in these paths)")
    del zipf, fvals, order, zs, starts, uniq_np, zipf_np, fvals_np
    torch.cuda.empty_cache()
    res["n_kv"], res["n"] = n_kv, n
    return res


N_SAMPLE_TYPED = 1 << 20  # int32 / float32 keys through the codec
N_SAMPLE_ADV = 1 << 24  # reverse block-sorted keys: the fallback and the overflow
N_SAMPLE_TINY = 8000  # shards and reassembly buffers of <= 2^14 keys: B3
N_SAMPLE_KV8 = 1 << 27  # kv rows with 8-byte payloads
N_SAMPLE_KV64 = 1 << 25  # kv rows with 64-byte payloads
N_SAMPLE_LSD64 = 1 << 26  # the 64-bit LSD composition (single_pass=False)


def sample_path(dev, card: str, part: torch.Tensor, part_np: np.ndarray,
                want: np.ndarray, keep: dict) -> dict:
    """The mesh sample sort (PSRS) at full size, on one rank and on four
    ranks of ``dev``: 32-bit keys (``part``, 256Mi PCG32 keys on the card,
    ``want`` their np.sort) through both reassemblies, int32 / float32
    keys, all-equal and Zipf(1.1) keys (no fallback), adversarial placement
    (the fallback, and OverflowError_ without it), shards of <= 2^14 keys
    (B3); kv rows with 8- and 64-byte payloads; 64-bit keys in one pass and
    through the LSD composition, and 64-bit kv rows.  Each run has its
    launch counts set to 0 just before and read just after and is exact
    against a numpy oracle; times are CUDA-event medians of 10 beside
    ``torch.sort`` of the same keys and the four-rank mesh LSD ``rdma``
    sort.  ``keep`` holds oracles made by the kv and table path ("zipf",
    "u64", "kv8", "kv64_order"); what it lacks is made here.  Returns the
    results for the JSON line."""
    import gpu_radix_sort_tpu_torch as port
    from gpu_radix_sort_tpu_torch.ops import binning as bn
    from gpu_radix_sort_tpu_torch.ops import block_sort as bs
    from gpu_radix_sort_tpu_torch.ops import digit_sort as ds
    from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
    from gpu_radix_sort_tpu_torch.ops import onesweep as osw
    from gpu_radix_sort_tpu_torch.ops import radix_sort as rs
    from gpu_radix_sort_tpu_torch.ops import single_block as sb
    from gpu_radix_sort_tpu_torch.ops.bits import encode_ordered64
    from gpu_radix_sort_tpu_torch.parallel import distributed as dist
    from gpu_radix_sort_tpu_torch.parallel import sample_sort as ss
    from gpu_radix_sort_tpu_torch.parallel.mesh import key_mesh, shard
    from gpu_radix_sort_tpu_torch.utils import keygen, timers

    t_path = time.perf_counter()
    counters = {"onesweep": osw, "block_sort": bs, "merge_level": ms,
                "single_block_sort": sb, "digit_sort": ds, "binning": bn}
    none = dict.fromkeys(counters, 0)
    res = {"launches": {}, "peak_mib": {}, "ms": {}, "card": card}
    passes32 = 32 // bn.PASS_WIDTH
    n = part.numel()
    P = MESH_RANKS
    mesh1, mesh4 = key_mesh([dev]), key_mesh([dev] * P)

    def run(name: str, fn, expect: dict):
        """fn() with the counts set to 0 just before and read just after;
        fails unless they are ``expect`` (kernels not named: 0)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for mod in counters.values():
            mod.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: mod.launches for k, mod in counters.items()}
        if got != {**none, **expect}:
            fail(f"sample path {name}: launches {got}, expected {expect}")
        res["launches"][name] = {k: v for k, v in got.items() if v}
        res["peak_mib"][name] = (torch.cuda.max_memory_allocated() - held) / 2**20
        return out

    def exact(got: torch.Tensor, want_np: np.ndarray, what: str) -> None:
        g = got.cpu().numpy()
        if g.dtype != want_np.dtype or g.shape != want_np.shape:
            fail(f"sample path {what}: {g.dtype} {g.shape}, expected {want_np.dtype} "
                 f"{want_np.shape}")
        if g.dtype.kind == "f":  # NaNs and signed zeros compare as bits
            g, want_np = g.view(f"u{g.itemsize}"), want_np.view(f"u{g.itemsize}")
        if not np.array_equal(g, want_np):
            fail(f"sample path {what} differs from the numpy oracle")

    def levels(m: int, run_: int) -> int:
        return ((m - 1) // run_).bit_length() if m > run_ else 0

    def keys_only(ranks: int, n_keys: int, reassembly: str) -> dict:
        """Launches of the 32-bit sample sort of n_keys keys on ranks ranks."""
        n_local = max(-(-n_keys // ranks), ranks)
        cap = ss.default_pair_capacity(n_local, ranks, 1.5)
        m = ranks * cap + n_local
        return launches_sum(
            full_sort_launches(n_local, ranks),
            full_sort_launches(m, ranks) if reassembly == "sort"
            else {"merge_level": ranks * levels(m, cap)})

    def timed(name: str, fn) -> float:
        res["ms"][name] = timers.time_cuda(fn)
        return res["ms"][name]

    # -- 32-bit keys: the main path, four ranks, then one rank ---------------
    runs32 = [(P, mesh4, "sort"), (P, mesh4, "merge"), (1, mesh1, "sort"), (1, mesh1, "merge")]
    for ranks, mesh_, reassembly in runs32:
        name = f"u32 {reassembly} {ranks}r"
        out = run(name, lambda: port.sort_distributed_sample(
            part, mesh=mesh_, reassembly=reassembly, fallback=False),
            keys_only(ranks, n, reassembly))
        exact(out, want, f"sort_distributed_sample {name} of {n} keys")
        del out
        log(f"sample path: sort_distributed_sample(reassembly={reassembly!r}) of {n} PCG32 "
            f"keys on {ranks} rank(s) of {dev} exact; launches {res['launches'][name]}; "
            f"peak device memory {res['peak_mib'][name]:.0f} MiB above the keys")

    n_tiny = N_SAMPLE_TINY
    for reassembly in ("sort", "merge"):
        name = f"u32 {reassembly} {P}r tiny"
        out = run(name, lambda: port.sort_distributed_sample(
            part[:n_tiny], mesh=mesh4, reassembly=reassembly, fallback=False),
            keys_only(P, n_tiny, reassembly))
        exact(out, np.sort(part_np[:n_tiny]), f"{name} ({n_tiny} keys)")
    n_typed = N_SAMPLE_TYPED
    ints = part_np[:n_typed].view(np.int32)
    floats = part_np[n_typed:2 * n_typed].copy()
    floats[:8] = [0x7FC00000, 0xFFC00001, 0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                  0x80000000, 0x00000000]
    floats[8::97] = 0x80000000
    floats = floats.view(np.float32)
    exact(port.sort_distributed_sample(torch.from_numpy(ints).to(dev), mesh=mesh4),
          np.sort(ints), f"int32 keys at {n_typed}")
    got = port.sort_distributed_sample(torch.from_numpy(floats).to(dev), mesh=mesh4,
                                       reassembly="merge")
    if not np.array_equal(total_order_np(got.cpu().numpy()), np.sort(total_order_np(floats))):
        fail("sample path: float32 keys differ from the numpy totalOrder sort")
    equal = torch.full((n,), 0x9E3779B9 - (1 << 32), dtype=torch.int32, device=dev)
    out = run(f"u32 all-equal {P}r", lambda: port.sort_distributed_sample(
        equal.view(torch.uint32), mesh=mesh4, fallback=False), keys_only(P, n, "sort"))
    if not torch.equal(out.view(torch.int32), equal):
        fail(f"sample path: all-equal keys at {n} differ")
    del out, equal, got
    if "zipf" in keep:
        zipf_np, zipf_sorted = keep["zipf"]
    else:
        zipf_np = keygen.generate_zipf_keys(n, alpha=1.1)
        zipf_sorted = np.sort(zipf_np)
    zipf = torch.from_numpy(zipf_np).to(dev)
    out = run(f"u32 zipf {P}r", lambda: port.sort_distributed_sample(
        zipf, mesh=mesh4, fallback=False), keys_only(P, n, "sort"))
    exact(out, zipf_sorted, f"Zipf(1.1) keys at {n}")
    del out, zipf, zipf_np, zipf_sorted
    n_adv = N_SAMPLE_ADV
    adv_sorted = want[::n // n_adv]  # sorted keys: reverse them block by block
    adv = torch.from_numpy(adv_sorted.reshape(P, -1)[::-1].copy().reshape(-1)).to(dev)
    try:
        port.sort_distributed_sample(adv, mesh=mesh4, fallback=False)
        fail("sample path: adversarial placement did not raise OverflowError_")
    except ss.OverflowError_:
        pass
    exact(port.sort_distributed_sample(adv, mesh=mesh4), adv_sorted,
          f"adversarial placement at {n_adv} through the fallback")
    del adv
    log(f"sample path: {n_tiny} keys (B3) exact through both reassemblies; int32 and "
        f"float32 (NaNs, +-0.0) at {n_typed} exact; all-equal and Zipf(1.1) keys at {n} "
        f"exact with no fallback; reverse block-sorted keys at {n_adv} raise "
        f"OverflowError_ without the fallback and are exact through it "
        f"({time.perf_counter() - t_path:.1f} s so far)")

    # -- times of the 32-bit sort ----------------------------------------------
    shards4, shards1 = shard(part, mesh4), shard(part, mesh1)
    fn4 = {r: ss.build_sample_sort(mesh4, n // P, reassembly=r)[0] for r in ("sort", "merge")}
    fn1 = {r: ss.build_sample_sort(mesh1, n, reassembly=r)[0] for r in ("sort", "merge")}
    for r in ("sort", "merge"):
        timed(f"u32 {r} {P}r", lambda: fn4[r](shards4))
        timed(f"u32 {r} 1r", lambda: fn1[r](shards1))
    timed(f"u32 sort {P}r entry", lambda: port.sort_distributed_sample(part, mesh=mesh4))
    lsd = dist.build_distributed_sort(mesh4, n // P, width=8, exchange="rdma")
    t_torch = timed("torch.sort u32", lambda: rs.sort_full(part, strategy="torch"))
    t_lsd = timed(f"mesh LSD rdma {P}r", lambda: lsd(shards4))
    log(f"time [{card}]: sample sort of {n} keys, {P} ranks on {dev}: reassembly sort "
        f"{res['ms'][f'u32 sort {P}r']:.3f} ms, merge {res['ms'][f'u32 merge {P}r']:.3f} ms "
        f"(build_sample_sort's function; sort_distributed_sample whole "
        f"{res['ms'][f'u32 sort {P}r entry']:.3f} ms); one rank: sort "
        f"{res['ms']['u32 sort 1r']:.3f} ms, merge {res['ms']['u32 merge 1r']:.3f} ms; "
        f"torch.sort {t_torch:.3f} ms; mesh LSD rdma, {P} ranks, {t_lsd:.3f} ms")
    syncs = host_syncs(lambda: fn4["sort"](shards4))
    res["host_syncs_4r"] = len(syncs)
    control = host_syncs(lambda: int(part[0]))  # a read of the device waits
    if not control:
        fail("sample path: sync debug mode saw no wait in a read of the device")
    log(f"sample path: {len(syncs)} host synchronisations in build_sample_sort's "
        f"function{': ' if syncs else ''}{'; '.join(sorted(set(syncs))[:3])} (a read "
        f"of the device: {len(control)})")
    log_profile(card, f"sort_distributed_sample, {P} ranks on {dev}, {n} keys, "
                f"reassembly sort", lambda: fn4["sort"](shards4), top=10)
    log_profile(card, f"sort_distributed_sample, {P} ranks on {dev}, {n} keys, "
                f"reassembly merge", lambda: fn4["merge"](shards4), top=6)
    del shards4, shards1, fn4, fn1, lsd
    torch.cuda.empty_cache()

    # -- key-value rows --------------------------------------------------------
    kv_sort = 2 * passes32  # launches of one stable kv sort: keys and a column a pass
    n_kv = N_SAMPLE_KV8
    keys = part[:n_kv]
    if "kv8" in keep and keep["kv8"][0].size == n_kv:
        order, payload8_np = keep["kv8"]
    else:
        order = stable_order_u32(part_np[:n_kv])
        payload8_np = keygen.generate_payloads(n_kv, payload_bytes=8)
    payload8 = torch.from_numpy(payload8_np).to(dev)
    name = f"kv p8B {P}r"
    sk, sv = run(name, lambda: port.sort_key_value_distributed(keys, payload8, mesh=mesh4),
                 {"binning": 2 * kv_sort * P})
    exact(sk, part_np[:n_kv][order], f"{name} keys")
    exact(sv, take_rows(payload8_np, order), f"{name} payload")
    del sk, sv, order
    timed(name, lambda: port.sort_key_value_distributed(keys, payload8, mesh=mesh4))
    timed("torch kv p8B", lambda: rs.sort_key_value(keys, payload8, strategy="torch"))
    n_kv64 = N_SAMPLE_KV64
    keys64b = part[:n_kv64]
    order = stable_order_u32(part_np[:n_kv64])
    payload64_np = keygen.generate_payloads(n_kv64, payload_bytes=64)
    payload64 = torch.from_numpy(payload64_np).to(dev)
    name = f"kv p64B {P}r"
    sk, sv = run(name, lambda: port.sort_key_value_distributed(keys64b, payload64, mesh=mesh4),
                 {"binning": 2 * kv_sort * P})
    exact(sk, part_np[:n_kv64][order], f"{name} keys")
    exact(sv, take_rows(payload64_np, order), f"{name} payload")
    del sk, sv, order, payload64_np
    timed(name, lambda: port.sort_key_value_distributed(keys64b, payload64, mesh=mesh4))
    timed("torch kv p64B", lambda: rs.sort_key_value(keys64b, payload64, strategy="torch"))
    del payload64
    log(f"sample path: sort_key_value_distributed of {n_kv} keys with 8-byte payloads and "
        f"{n_kv64} with 64-byte payloads on {P} ranks, exact against numpy's stable order; "
        f"{res['ms'][f'kv p8B {P}r']:.3f} / {res['ms'][f'kv p64B {P}r']:.3f} ms, the "
        f"torch route on one device {res['ms']['torch kv p8B']:.3f} / "
        f"{res['ms']['torch kv p64B']:.3f} ms ({time.perf_counter() - t_path:.1f} s so far)")

    # -- 64-bit keys -----------------------------------------------------------
    torch.cuda.empty_cache()
    if "u64" in keep:
        u64_np, u64_sorted = keep["u64"]
    else:
        u64_np = np.random.default_rng(64).integers(0, 1 << 64, n, dtype=np.uint64)
        u64_sorted = np.sort(u64_np)
    u64 = torch.from_numpy(u64_np).to(dev)
    name = f"u64 {P}r"
    out = run(name, lambda: port.sort_distributed_64(u64, mesh=mesh4), {})
    exact(out, u64_sorted, f"sort_distributed_64 of {n} keys")
    del out
    timed(name, lambda: port.sort_distributed_64(u64, mesh=mesh4))
    timed("torch u64", lambda: torch.sort(encode_ordered64(u64)))
    n_lsd = N_SAMPLE_LSD64
    name = f"u64 lsd {P}r"
    out = run(name, lambda: port.sort_distributed_64(u64[:n_lsd], mesh=mesh4, single_pass=False),
              {"binning": 2 * 2 * kv_sort * P})  # two kv sample sorts
    exact(out, np.sort(u64_np[:n_lsd]), f"sort_distributed_64(single_pass=False) of {n_lsd}")
    del out
    timed(name, lambda: port.sort_distributed_64(u64[:n_lsd], mesh=mesh4, single_pass=False))
    keys64 = u64[:n_kv]
    if "kv64_order" in keep and keep["kv64_order"].size == n_kv:
        order = keep["kv64_order"]
    else:
        order = np.argsort(u64_np[:n_kv], kind="stable")
    name = f"kv64 p8B {P}r"
    sk, sv = run(name, lambda: port.sort_key_value_distributed_64(keys64, payload8, mesh=mesh4),
                 {"binning": 2 * 3 * kv_sort * P})  # two words and a column, twice
    exact(sk, u64_np[:n_kv][order], f"{name} keys")
    exact(sv, take_rows(payload8_np, order), f"{name} payload")
    del sk, sv, order
    timed(name, lambda: port.sort_key_value_distributed_64(keys64, payload8, mesh=mesh4))

    def kv64_torch():
        o = torch.sort(encode_ordered64(keys64), stable=True).indices
        return keys64.view(torch.int64)[o], payload8[o]

    timed("torch kv64 p8B", kv64_torch)
    log(f"sample path: sort_distributed_64 of {n} uint64 keys (one pass) and of {n_lsd} "
        f"(the LSD composition), sort_key_value_distributed_64 of {n_kv} with 8-byte "
        f"payloads, on {P} ranks, exact; {res['ms'][f'u64 {P}r']:.3f} / "
        f"{res['ms'][f'u64 lsd {P}r']:.3f} / {res['ms'][f'kv64 p8B {P}r']:.3f} ms; "
        f"torch.sort of the int64 words {res['ms']['torch u64']:.3f} ms, a stable "
        f"torch.sort and a row gather {res['ms']['torch kv64 p8B']:.3f} ms")
    del u64, keys64, payload8, u64_np, u64_sorted, payload8_np
    torch.cuda.empty_cache()
    res.update(n=n, ranks=P, n_typed=n_typed, n_adv=n_adv, n_tiny=n_tiny, n_kv8=n_kv,
               n_kv64=n_kv64, n_lsd64=n_lsd)
    log(f"sample path: every phase exact ({time.perf_counter() - t_path:.1f} s)")
    return res


N_AGG = 1 << 28  # the hash aggregate's Zipf(1.2) keys: 256Mi, 1 GiB
N_AGG_VALUES = 1 << 24  # the value ops, the predicate and key_order
N_AGG_TINY = 12_500  # selftest --n 100000's aggregate on one card: B3
KEY_ORDER_SIZES = tuple(1 << e for e in range(10, 21))  # the key_order crossover


def aggregate_inputs(n: int):
    """The hash aggregate's cell (the JAX harness's, bench/harness.py:392-418):
    generate_zipf_keys(n, alpha=1.2, seed=9), and its np.unique with
    counts.  Run in a :func:`side_pool`."""
    from gpu_radix_sort_tpu_torch.utils import keygen

    keys = keygen.generate_zipf_keys(n, alpha=1.2, seed=9)
    uniq, counts = np.unique(keys, return_counts=True)
    return keys, uniq, counts


def check_groups(what: str, keys: list, aggs: list, uniq: np.ndarray,
                 counts: np.ndarray) -> None:
    """Fails unless the ranks' (group keys, counts) numpy arrays are
    np.unique's groups exactly: each rank's keys ascending, every (key,
    count) one of np.unique's, every group once."""
    seen = np.zeros(uniq.size, np.int64)
    for r, (k, a) in enumerate(zip(keys, aggs)):
        if k.size > 1 and not (k[1:] > k[:-1]).all():
            fail(f"{what}: rank {r}'s group keys are not ascending")
        idx = np.minimum(np.searchsorted(uniq, k), max(uniq.size - 1, 0))
        if not (np.array_equal(uniq[idx], k) and np.array_equal(counts[idx], a.astype(np.int64))):
            fail(f"{what}: rank {r}'s groups differ from np.unique")
        seen += np.bincount(idx, minlength=uniq.size)
    if not (seen == 1).all():
        fail(f"{what}: {int((seen == 0).sum())} groups missing, {int((seen > 1).sum())} repeated")


def aggregate_path(dev, card: str, inputs=None) -> dict:
    """The distributed hash aggregate (hash-partition -> filter -> aggregate)
    at the JAX harness's cell: the count over 256Mi Zipf(1.2) keys on four
    ranks of ``dev`` and on one, through ``build_hash_aggregate``'s
    function, with the launch counts set to 0 just before and read just
    after, exact against np.unique with overflow 0; its time (CUDA-event
    median of 10), peak memory, a profile, the host waits inside it (none
    allowed), and the host entry's time; beside torch.unique and the
    single-device group_aggregate of the same keys.  Then on four ranks of
    16Mi of the keys through the host entry: float32 sum (within 1e-5 of
    float64, the same bytes twice), uint32 max, a predicate, key_order=True;
    the selftest's 12 500-key aggregate on one rank (B3); the key_order
    crossover (np.argsort on the host against sort_key_value on the card,
    2^10 to 2^20 groups); and ``python -m gpu_radix_sort_tpu_torch selftest
    --n 100000`` as a child process, which must pass.  ``inputs``, a future
    of :func:`aggregate_inputs`, or None to make them here."""
    import gpu_radix_sort_tpu_torch as port
    from gpu_radix_sort_tpu_torch.ops import binning as bn
    from gpu_radix_sort_tpu_torch.ops import block_sort as bs
    from gpu_radix_sort_tpu_torch.ops import digit_sort as ds
    from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
    from gpu_radix_sort_tpu_torch.ops import onesweep as osw
    from gpu_radix_sort_tpu_torch.ops import single_block as sb
    from gpu_radix_sort_tpu_torch.ops import table
    from gpu_radix_sort_tpu_torch.parallel import pipeline as pp
    from gpu_radix_sort_tpu_torch.parallel.mesh import key_mesh, shard
    from gpu_radix_sort_tpu_torch.utils import keygen, timers

    t_path = time.perf_counter()
    counters = {"onesweep": osw, "block_sort": bs, "merge_level": ms,
                "single_block_sort": sb, "digit_sort": ds, "binning": bn}
    none = dict.fromkeys(counters, 0)
    res = {"launches": {}, "peak_mib": {}, "ms": {}, "card": card}
    kv_sort = 2 * (32 // bn.PASS_WIDTH)  # a key-value sort: keys and one column a pass
    P = MESH_RANKS

    def run(name: str, fn, expect: dict):
        """fn() with the counts set to 0 just before and read just after;
        fails unless they are ``expect`` (kernels not named: 0)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for mod in counters.values():
            mod.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: mod.launches for k, mod in counters.items()}
        if got != {**none, **expect}:
            fail(f"aggregate path {name}: launches {got}, expected {expect}")
        res["launches"][name] = {k: v for k, v in got.items() if v}
        res["peak_mib"][name] = (torch.cuda.max_memory_allocated() - held) / 2**20
        return out

    keys_np, uniq, counts = inputs.result() if inputs is not None else aggregate_inputs(N_AGG)
    n = keys_np.size
    log(f"aggregate path: {n} Zipf(1.2) keys, {uniq.size} groups, the largest "
        f"{int(counts.max())} rows ({time.perf_counter() - t_path:.1f} s)")
    keys = torch.from_numpy(keys_np).to(dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)

    # -- the count at 256Mi on four ranks and on one -------------------------
    for ranks in (P, 1):
        mesh = key_mesh([dev] * ranks)
        n_local = n // ranks
        fn, cap = pp.build_hash_aggregate(mesh, n_local, op="count")
        args = (shard(keys, mesh), shard(ones, mesh), shard(valid, mesh))
        name = f"count {ranks}r"
        gk, ga, ng, overflow = run(name, lambda: fn(*args),
                                   {**full_sort_launches(n_local, ranks), "binning": kv_sort * ranks})
        if int(overflow):
            fail(f"aggregate path {name}: overflow {int(overflow)}")
        sizes = [int(g) for g in ng]
        check_groups(f"aggregate path {name}", [k[:c].cpu().numpy() for k, c in zip(gk, sizes)],
                     [a[:c].cpu().numpy() for a, c in zip(ga, sizes)], uniq, counts)
        # the two sorts a rank runs, alone: of its hashes, and the final one
        # over P x capacity rows, its groups first and 0xFFFFFFFF after
        final_keys = torch.full((ranks * cap,), -1, dtype=torch.int32, device=dev)
        final_keys[:sizes[0]] = gk[0][:sizes[0]].view(torch.int32)
        final_col = torch.ones_like(final_keys).view(torch.uint32)
        hashes = table.hash_u32(args[0][0])
        del gk, ga, ng
        res["ms"][f"hash sort a rank {name}"] = timers.time_cuda(lambda: port.sort_full(hashes))
        res["ms"][f"final kv sort a rank {name}"] = timers.time_cuda(
            lambda: port.sort_key_value(final_keys.view(torch.uint32), final_col))
        del final_keys, final_col, hashes
        res["ms"][name] = timers.time_cuda(lambda: fn(*args))
        syncs = host_syncs(lambda: fn(*args))
        if syncs:
            fail(f"aggregate path {name}: the host waits inside fn at {sorted(set(syncs))}")
        res[f"rows_per_s {name}"] = n / (res["ms"][name] * 1e-3)
        log(f"time [{card}]: hash aggregate count of {n} Zipf(1.2) keys on {ranks} ranks of "
            f"one card {res['ms'][name]:.3f} ms ({res[f'rows_per_s {name}']:.4g} rows/s; "
            f"P x capacity = {ranks * cap} rows a rank's final sort); exact against np.unique "
            f"({sum(sizes)} groups, by rank {sizes}), overflow 0; launches "
            f"{res['launches'][name]}; peak {res['peak_mib'][name]:.0f} MiB above the inputs; "
            f"no host waits inside fn; alone, a rank's sort_full of {n_local} hashes "
            f"{res['ms'][f'hash sort a rank {name}']:.3f} ms and its final sort_key_value of "
            f"{ranks * cap} rows {res['ms'][f'final kv sort a rank {name}']:.3f} ms ({ranks} "
            f"of each: {100 * ranks * res['ms'][f'hash sort a rank {name}'] / res['ms'][name]:.1f}"
            f"% and {100 * ranks * res['ms'][f'final kv sort a rank {name}'] / res['ms'][name]:.1f}%)")
        if ranks == P:
            log_profile(card, f"hash aggregate count of {n} keys on {P} ranks", lambda: fn(*args))
        del fn, args
        torch.cuda.empty_cache()
    mesh4 = key_mesh([dev] * P)
    gk, ga = pp.hash_aggregate_distributed(keys, op="count", mesh=mesh4)
    o = np.argsort(gk)
    check_groups("aggregate path host entry", [gk[o]], [ga[o]], uniq, counts)
    res["ms"][f"host entry count {P}r"] = timers.time_wall(
        lambda: pp.hash_aggregate_distributed(keys, op="count", mesh=mesh4), iters=3)
    del gk, ga, o

    # -- yardsticks on the same keys -------------------------------------------
    res["ms"]["torch.unique"] = timers.time_cuda(
        lambda: torch.unique(keys.view(torch.int32), sorted=True, return_counts=True))
    if torch.unique(keys.view(torch.int32)).numel() != uniq.size:
        fail("aggregate path: torch.unique counts other groups than np.unique")
    gu, gc, gn = run("group_aggregate count", lambda: table.group_aggregate(keys, None, "count"),
                     full_sort_launches(n))
    g = int(gn)
    if g != uniq.size or not (np.array_equal(gu[:g].cpu().numpy(), uniq) and np.array_equal(
            gc[:g].cpu().numpy().astype(np.int64), counts)):
        fail("aggregate path: group_aggregate count differs from np.unique")
    del gu, gc
    res["ms"]["group_aggregate count"] = timers.time_cuda(
        lambda: table.group_aggregate(keys, None, "count"))
    log(f"time [{card}]: beside it, the same {n} keys: torch.unique(sorted=True, "
        f"return_counts=True) {res['ms']['torch.unique']:.3f} ms; the single-device "
        f"group_aggregate count {res['ms']['group_aggregate count']:.3f} ms (launches "
        f"{res['launches']['group_aggregate count']}); the host entry on {P} ranks "
        f"{res['ms'][f'host entry count {P}r']:.3f} ms (host clock, median of 3, ending in "
        f"its copy to the host)")
    del ones, valid
    torch.cuda.empty_cache()

    # -- value ops, a predicate and key_order at 16Mi on four ranks ------------
    nv = N_AGG_VALUES
    kv_np, kv = keys_np[:nv], keys[:nv]
    del keys_np, uniq, counts
    order = stable_order_u32(kv_np)
    starts = run_starts(kv_np[order])
    u = kv_np[order][starts]
    c = np.diff(np.append(starts, nv))
    rng = np.random.default_rng(12)
    f_np = rng.random(nv, dtype=np.float32)
    u_np = rng.integers(0, 1 << 32, nv, dtype=np.uint64).astype(np.uint32)
    f, uv = torch.from_numpy(f_np).to(dev), torch.from_numpy(u_np).to(dev)
    value_launches = {"binning": 2 * kv_sort * P}  # the local and the final kv sort

    def at(gk: np.ndarray) -> np.ndarray:
        idx = np.minimum(np.searchsorted(u, gk), u.size - 1)
        if gk.size != u.size or not np.array_equal(u[idx], gk) or np.unique(idx).size != u.size:
            fail(f"aggregate path: group keys at {nv} differ from np.unique")
        return idx

    name = f"sum f32 {P}r"
    gk, ga = run(name, lambda: pp.hash_aggregate_distributed(kv, f, op="sum", mesh=mesh4),
                 value_launches)
    want = np.add.reduceat(f_np[order].astype(np.float64), starts)[at(gk)]
    rel = float(np.max(np.abs(ga.astype(np.float64) - want) / np.abs(want)))
    again = pp.hash_aggregate_distributed(kv, f, op="sum", mesh=mesh4)
    if rel > 1e-5 or not (np.array_equal(again[0], gk) and np.array_equal(
            again[1].view(np.uint32), ga.view(np.uint32))):
        fail(f"aggregate path {name}: relative error {rel} against float64 (limit 1e-5), or "
             f"two calls gave different bytes")
    res["f32_sum_max_rel_err"] = rel
    res["ms"][name] = timers.time_wall(
        lambda: pp.hash_aggregate_distributed(kv, f, op="sum", mesh=mesh4), iters=3)
    name = f"max u32 {P}r"
    gk, ga = run(name, lambda: pp.hash_aggregate_distributed(kv, uv, op="max", mesh=mesh4),
                 value_launches)
    if not np.array_equal(ga, np.maximum.reduceat(u_np[order], starts)[at(gk)]):
        fail(f"aggregate path {name} differs from numpy")
    res["ms"][name] = timers.time_wall(
        lambda: pp.hash_aggregate_distributed(kv, uv, op="max", mesh=mesh4), iters=3)
    name = f"count even keys {P}r"
    gk, ga = run(name, lambda: pp.hash_aggregate_distributed(
        kv, op="count", mesh=mesh4, predicate=lambda k: (k & 1) == 0),
        {**full_sort_launches(nv // P, P), "binning": kv_sort * P})
    even, o = u % 2 == 0, np.argsort(gk)
    check_groups(f"aggregate path {name}", [gk[o]], [ga[o]], u[even], c[even])
    name = f"count key_order {P}r"
    device_order = u.size >= pp.KEY_ORDER_DEVICE_MIN
    gk, ga = run(name, lambda: pp.hash_aggregate_distributed(kv, op="count", mesh=mesh4,
                                                             key_order=True),
                 {**full_sort_launches(nv // P, P), "binning": kv_sort * (P + device_order)})
    if not (np.array_equal(gk, u) and np.array_equal(ga.astype(np.int64), c)):
        fail(f"aggregate path {name} differs from np.unique")
    del gk, ga, again, f, uv, kv, order, starts
    log(f"aggregate path: on {P} ranks, {nv} keys ({u.size} groups): float32 sum within "
        f"{rel:.3g} of float64 (limit 1e-5), the same bytes on two calls; uint32 max exact; "
        f"count of the even keys exact; key_order=True equal to np.unique ("
        f"{'sort_key_value on the card' if device_order else 'np.argsort'}); host entry "
        f"{res['ms'][f'sum f32 {P}r']:.3f} / {res['ms'][f'max u32 {P}r']:.3f} ms (sum / max)")

    # -- the selftest's aggregate: shards of <= 2^14 keys (B3) ------------------
    zk = keygen.generate_zipf_keys(N_AGG_TINY, alpha=1.3, seed=2)
    gk, ga = run("count tiny 1r", lambda: pp.hash_aggregate_distributed(
        zk, op="count", mesh=key_mesh([dev])), {**full_sort_launches(N_AGG_TINY), "binning": kv_sort})
    zu, zc = np.unique(zk, return_counts=True)
    check_groups("aggregate path count tiny 1r", [gk], [ga], zu, zc)

    # -- the key_order crossover --------------------------------------------------
    rng = np.random.default_rng(13)
    res["key_order_ms"] = {}
    for m in KEY_ORDER_SIZES:
        k_np = rng.permutation(np.unique(rng.integers(0, 1 << 32, 2 * m, dtype=np.uint64)
                                         .astype(np.uint32))[:m])
        k = torch.from_numpy(k_np).to(dev)
        a = torch.arange(m, dtype=torch.int32, device=dev).view(torch.uint32)
        for route in (pp._key_order_host, pp._key_order_device):
            sk, sa = route(k, a)
            if not (np.array_equal(sk, np.sort(k_np)) and np.array_equal(
                    k_np[sa.astype(np.int64)], sk)):
                fail(f"aggregate path: {route.__name__} of {m} keys is not np.sort's order")
        res["key_order_ms"][m] = {
            "host": timers.time_wall(lambda: pp._key_order_host(k, a), warmup=2, iters=10),
            "device": timers.time_wall(lambda: pp._key_order_device(k, a), warmup=2, iters=10)}
    faster = [m for m in KEY_ORDER_SIZES if all(
        res["key_order_ms"][q]["device"] <= res["key_order_ms"][q]["host"]
        for q in KEY_ORDER_SIZES if q >= m)]
    res["key_order_crossover"] = faster[0] if faster else None
    log(f"time [{card}]: key_order over m distinct groups, np.argsort on the host / "
        f"sort_key_value on the card, each ending on the host (host clock, median of 10): " +
        "; ".join(f"2^{m.bit_length() - 1} {t['host']:.3f} / {t['device']:.3f} ms"
                  for m, t in res["key_order_ms"].items()) +
        f"; the card from {res['key_order_crossover']} groups (KEY_ORDER_DEVICE_MIN is "
        f"{pp.KEY_ORDER_DEVICE_MIN})")
    torch.cuda.empty_cache()

    # -- the CLI selftest on the card, as a child process ------------------------
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gpu_radix_sort_tpu_torch", "selftest", "--n", "100000"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = proc.stdout.splitlines()
    if proc.returncode or not lines or lines[-1] != "selftest: OK":
        fail(f"selftest --n 100000 exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    res["selftest_s"] = time.perf_counter() - t0
    log(f"aggregate path: python -m gpu_radix_sort_tpu_torch selftest --n 100000 on the "
        f"card: {sum(line.startswith('  PASS') for line in lines)} checks, every one PASS "
        f"({res['selftest_s']:.1f} s)")
    res.update(n=n, ranks=P, n_values=nv, n_tiny=N_AGG_TINY)
    log(f"aggregate path: every phase exact ({time.perf_counter() - t_path:.1f} s)")
    return res


# The names of the JAX package's run_benchmarks("full") rows, in order
# (gpu_radix_sort_tpu/bench/harness.py:611-653): the port's suite must give
# the same rows.
BENCH_FULL_ROWS = (
    "keygen_pcg32", "full_sort_u32", "partial_sort_u32_w4", "partial_sort_u32_w8",
    "partial_sort_u32_w16", "partial_sort_u32_w8_refcontract",
    "partial_sort_u32_w16_refcontract", "kv_sort_u32_p8B", "kv_digit_sort_w4",
    "kv_sort_u32_p64B", "mesh_lsd_w8_alltoall", "mesh_sample_sort", "mesh_sort64",
    "mesh_sort64_lsd", "mesh_kv_sample_p64B", "hash_aggregate_count_zipf", "full_sort_u64",
    "storage_mem_local_w8", "storage_device_local_w8", "storage_kv_mem_p64B_w8",
    "storage_u64_mem_w8", "storage_u64_device_w8",
)
N_BENCH = 1 << 28  # the full suite's n1 on the card: 256Mi keys
BENCH_MESH_CAP = 8 << 20  # the full suite's mesh rows: at most 8Mi keys a rank
BENCH_STEP_S = 200  # the step's share of the script's 1200 s
TIMER_TOLERANCE = 0.15  # the harness's median against CUDA events of the same call


def bench_path(dev, card: str) -> dict:
    """Step 14, the harness: ``bench --suite full --json`` as a child process
    on the card, its 22 records checked (names and order, times, overflow,
    the storage rows' rounds) and written to chiprun_out/; ``analyze`` of
    the file alone and against itself; then, in this process, the native
    key fill against numpy's, the launches of one call of every row that
    runs on the card, and the harness's timer against CUDA events of the
    same sort.  Returns the results for the JSON line."""
    import contextlib
    import io
    from pathlib import Path

    from gpu_radix_sort_tpu_torch import cli
    from gpu_radix_sort_tpu_torch.bench import harness
    from gpu_radix_sort_tpu_torch.ops import binning as bn
    from gpu_radix_sort_tpu_torch.ops import block_sort as bs
    from gpu_radix_sort_tpu_torch.ops import digit_sort as ds
    from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
    from gpu_radix_sort_tpu_torch.ops import onesweep as osw
    from gpu_radix_sort_tpu_torch.ops import radix_sort as rs
    from gpu_radix_sort_tpu_torch.ops import single_block as sb
    from gpu_radix_sort_tpu_torch.parallel.mesh import key_mesh
    from gpu_radix_sort_tpu_torch.utils import keygen, timers

    t_step = time.perf_counter()
    res = {"card": card, "launches": {}}
    torch.cuda.empty_cache()

    # -- the full suite in a child process, as a user runs it ----------------
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "bench_full.jsonl"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gpu_radix_sort_tpu_torch", "bench", "--suite", "full",
         "--json"], capture_output=True, text=True, timeout=900)
    res["suite_s"] = time.perf_counter() - t0
    path.write_text(proc.stdout)
    if proc.returncode:
        fail(f"bench --suite full exited {proc.returncode}:\n{proc.stderr[-6000:]}")
    records = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    names = tuple(r["name"] for r in records)
    if names != BENCH_FULL_ROWS:
        fail(f"bench --suite full rows {names}, expected {BENCH_FULL_ROWS}")
    log(f"bench: `python -m gpu_radix_sort_tpu_torch bench --suite full --json` in "
        f"{res['suite_s']:.1f} s, {len(records)} records in {path}")
    for r in records:
        if not r["median_s"] > 0:
            fail(f"bench {r['name']}: median_s {r['median_s']}")
        if r["extra"].get("overflow", 0) != 0:
            fail(f"bench {r['name']}: overflow {r['extra']['overflow']}")
        if r["name"].startswith("storage_"):
            bits = 64 if r["name"].startswith("storage_u64_") else 32
            rounds = bits // int(r["name"].rsplit("_w", 1)[1]) * r["reps"]
            got = r["extra"]["phases"].get("counter:rounds")
            if got != rounds:
                fail(f"bench {r['name']}: counter:rounds {got}, expected {rounds}")
        log(f"bench [{card}]: {harness.BenchRecord(**r).line()}")
    res["records"] = records

    # -- analyze, alone and against itself -----------------------------------
    for files in ([str(path)], [str(path), str(path)]):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli.main(["analyze", *files])
        if rc:
            fail(f"analyze {files} exited {rc}")
        rows = text.getvalue().splitlines()
        if len(files) == 2 and (len(rows) != 1 + len(records)
                                or not all(row.endswith(" 1.00x") for row in rows[1:])):
            fail(f"analyze of the file against itself:\n{text.getvalue()}")
        log(f"analyze {' '.join(files)}:\n{text.getvalue()}")

    # -- the native key fill against its plain numpy version -----------------
    t0 = time.perf_counter()
    native_keys = keygen.Pcg32().fill(N_BENCH)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain_keys = keygen.Pcg32().fill_plain(N_BENCH)
    plain_s = time.perf_counter() - t0
    if not np.array_equal(native_keys, plain_keys):
        fail(f"the native PCG32 fill of {N_BENCH} keys differs from the numpy fill")
    del native_keys, plain_keys
    res["fill_s"] = {"native": native_s, "numpy": plain_s, "cpus": os.cpu_count()}
    log(f"time [host, {os.cpu_count()} CPUs]: Pcg32().fill of {N_BENCH} keys {native_s:.3f} s "
        f"(native, threads), the numpy fill {plain_s:.3f} s; the same words")

    # -- one call of each row that runs on the card, counted ----------------
    counters = {"onesweep": osw, "block_sort": bs, "merge_level": ms,
                "single_block_sort": sb, "digit_sort": ds, "binning": bn}
    none = dict.fromkeys(counters, 0)

    def one_call(fn, args, **_):
        """The harness's timer, replaced: one call of the row's function."""
        return 1.0, 1.0, 0.0, fn(*args)

    P = key_mesh().size
    n_local = min(N_BENCH // P, BENCH_MESH_CAP)
    kv_sort = 2 * (32 // bn.PASS_WIDTH)  # keys and one column a pass

    def storage(bench, n: int, backend: str):
        cfg = harness.SortConfig(backend=backend, device=str(dev))  # 2 workers
        return lambda: bench(n, cfg, warmup=False)  # one call: one rep, no warmup

    # row -> (one call of it, its launches: exact, or None for "some kernel")
    rows = {
        "full_sort_u32": (lambda: harness.bench_full_sort(N_BENCH, device=dev),
                          full_sort_launches(N_BENCH)),
        **{f"partial_sort_u32_w{w}": (
            lambda w=w: harness.bench_partial_sort(N_BENCH, width=w, device=dev),
            {"binning": -(-w // bn.PASS_WIDTH)}) for w in (4, 8, 16)},
        "partial_sort_u32_w8_refcontract": (
            lambda: harness.bench_partial_sort(N_BENCH, width=8, stable=False, device=dev),
            full_sort_launches(N_BENCH)),
        "kv_sort_u32_p8B": (
            lambda: harness.bench_key_value_sort(N_BENCH // 2, payload_bytes=8, device=dev),
            {"binning": kv_sort}),
        "kv_digit_sort_w4": (
            lambda: harness.bench_kv_digit_sort(N_BENCH, width=4, device=dev),
            {"binning": 2}),
        "kv_sort_u32_p64B": (
            lambda: harness.bench_key_value_sort(N_BENCH // 16, payload_bytes=64, device=dev),
            {"binning": kv_sort}),
        "mesh_lsd_w8_alltoall": (lambda: harness.bench_mesh_lsd(n_local, device=dev), None),
        "mesh_sample_sort": (lambda: harness.bench_mesh_sample(n_local, device=dev), None),
        # one int64 torch.sort of the encoded words, as JAX runs lax.sort
        "mesh_sort64": (lambda: harness.bench_mesh_sort64(n_local // 2, device=dev), {}),
        "mesh_sort64_lsd": (
            lambda: harness.bench_mesh_sort64_lsd(n_local // 2, device=dev), None),
        "mesh_kv_sample_p64B": (
            lambda: harness.bench_mesh_kv_sample(max(n_local // 4, 1 << 12), device=dev),
            None),
        "hash_aggregate_count_zipf": (
            lambda: harness.bench_hash_aggregate(n_local, device=dev),
            {**full_sort_launches(n_local, P), "binning": kv_sort * P}),
        "full_sort_u64": (lambda: harness.bench_full_sort_u64(16 << 20, device=dev), {}),
        "storage_mem_local_w8": (storage(harness.bench_storage_distrib, 1 << 20, "mem"),
                                 None),
        "storage_device_local_w8": (
            storage(harness.bench_storage_distrib, 8 << 20, "device"), None),
        # the kv and 64-bit storage rows order digits by torch.sort (the
        # fused 64-bit loop by int64 torch.sort), as JAX's by XLA sorts
        "storage_kv_mem_p64B_w8": (storage(harness.bench_storage_kv, 1 << 19, "mem"), {}),
        "storage_u64_mem_w8": (storage(harness.bench_storage_u64, 1 << 19, "mem"), {}),
        "storage_u64_device_w8": (storage(harness.bench_storage_u64, 4 << 20, "device"),
                                  {}),
    }
    timer = harness.device_time
    harness.device_time = one_call
    try:
        for name, (row, expect) in rows.items():
            torch.cuda.synchronize()
            for mod in counters.values():
                mod.launches = 0
            rec = row()
            torch.cuda.synchronize()
            got = {k: mod.launches for k, mod in counters.items()}
            if rec.name != name:
                fail(f"bench row {rec.name}, expected {name}")
            if (got != {**none, **expect}) if expect is not None else not any(got.values()):
                fail(f"bench row {name}: launches {got}, expected "
                     f"{'some kernel' if expect is None else {**none, **expect}}")
            res["launches"][name] = {k: v for k, v in got.items() if v}
            log(f"bench row {name}: one call launches {res['launches'][name]}")
    finally:
        harness.device_time = timer

    # -- the harness's timer against CUDA events of the same sort ------------
    rec = harness.bench_full_sort(N_BENCH, reps=3, device=dev)
    keys = torch.from_numpy(keygen.Pcg32().fill(N_BENCH)).to(dev)
    events_ms = timers.time_cuda(lambda: rs.sort_full(keys))
    del keys
    harness_ms = rec.median_s * 1e3
    child_ms = records[BENCH_FULL_ROWS.index("full_sort_u32")]["median_s"] * 1e3
    res["timer_check"] = {"harness_ms": harness_ms, "time_cuda_ms": events_ms,
                          "suite_child_ms": child_ms}
    log(f"time [{card}]: full_sort_u32 of {N_BENCH} keys: the harness's median "
        f"{harness_ms:.3f} ms, time_cuda of the same sort {events_ms:.3f} ms "
        f"({harness_ms / events_ms:.3f}x), the suite's child process {child_ms:.3f} ms")
    if abs(harness_ms / events_ms - 1) > TIMER_TOLERANCE:
        fail(f"the harness's full_sort_u32 median {harness_ms:.3f} ms is not within "
             f"{TIMER_TOLERANCE:.0%} of time_cuda's {events_ms:.3f} ms")
    res["step_s"] = time.perf_counter() - t_step
    log(f"bench step: {res['step_s']:.1f} s (its share of the script: {BENCH_STEP_S} s)")
    if res["step_s"] > BENCH_STEP_S:
        log(f"bench step: over its {BENCH_STEP_S} s share by "
            f"{res['step_s'] - BENCH_STEP_S:.1f} s")
    return res


# -- the out-of-core runner (benchmarks/run_out_of_core.py) ------------------

OOC_DIR = "_ooc_smoke"  # the runner's mount (listed in .gitignore)
OOC_WIDTH = 8
# Step 15: the runner's two configurations at their widths (4-byte keys;
# 68-byte rows of 64-byte payloads), their rows cut to fit the script's time.
N_OOC_KEYS = 1 << 27  # 512 MiB: the published 1Gi keys cut by 8
N_OOC_KV = 1 << 23  # 544 MiB: the published 256Mi rows cut by 32
OOC_WORKERS = 2
# --out-of-core: the published configurations, unchanged (the JAX runner's
# docstring, README.md's out-of-core rows): rows, payload bytes.
OOC_PUBLISHED = ((1 << 30, 0), (1 << 28, 64))
OOC_DISK_SLACK = 1 << 30  # bytes of free disk over the input and one round's outputs
OOC_MEM_SLACK = 4 << 30  # bytes of host memory over three copies of the rows
GiB = 2**30


def proc_bytes(path: str, field: str) -> int:
    """A "field: N kB" line of a /proc file, in bytes: VmRSS of
    /proc/self/status (this process's resident memory), MemAvailable of
    /proc/meminfo (the host's available memory)."""
    with open(path) as f:
        for line in f:
            if line.startswith(f"{field}:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError(f"no {field} in {path}")


def ooc_room(mount: str, rows: int, payload_bytes: int) -> dict:
    """Fails, with the numbers, unless ``mount``'s filesystem has room for
    the input and one round's outputs at once and the host's available
    memory holds three copies of the rows (a kv worker's shard and its
    permuted records; the proof's keys and their np.sort)."""
    data = rows * (4 + payload_bytes)
    free, avail = shutil.disk_usage(mount).free, proc_bytes("/proc/meminfo", "MemAvailable")
    need_disk, need_mem = 2 * data + OOC_DISK_SLACK, 3 * data + OOC_MEM_SLACK
    log(f"out-of-core: {rows} rows of {4 + payload_bytes} bytes ({data / GiB:.1f} GiB): "
        f"free disk on {mount} {free / GiB:.1f} GiB (needs {need_disk / GiB:.1f}), "
        f"available host memory {avail / GiB:.1f} GiB (needs {need_mem / GiB:.1f})")
    if free < need_disk:
        fail(f"out-of-core: {need_disk / GiB:.1f} GiB of disk needed on {mount}, "
             f"{free / GiB:.1f} GiB free")
    if avail < need_mem:
        fail(f"out-of-core: {need_mem / GiB:.1f} GiB of host memory needed, "
             f"{avail / GiB:.1f} GiB available")
    return {"free_disk_gib": free / GiB, "available_memory_gib": avail / GiB}


def ooc_name(rows: int, payload_bytes: int) -> str:
    return f"{'kv' + str(payload_bytes) + 'B' if payload_bytes else 'keys'} {rows}"


def ooc_run(card: str, mount: str, rows: int, payload_bytes: int, nworker: int) -> dict:
    """One in-process run of the port's runner (``main``) at ``rows`` rows
    of 4 + ``payload_bytes`` bytes, width OOC_WIDTH, ``nworker`` workers,
    on the card, with the launch counts set to 0 just before and read just
    after: the keys workers' stable w8 sorts are two B5 passes a worker and
    round, the kv workers' digit orders a torch.sort (no kernel), as the JAX
    runner's XLA sorts.  Fails unless it exits 0 with ``exact`` true and
    those launches.  Samples this process's resident memory and the bytes
    used on the mount's filesystem every 0.2 s, and breaks the run's host
    clock into staging, the proof and, inside the workers (which run one
    at a time), their file reads, their sorts on the card (synchronised)
    and their bucket writes; the rest of the workers' time is the copies
    to and from the card and, for kv rows, the permute of the rows.
    Returns its JSON line with the launches, the peaks, the breakdown and
    the run's seconds."""
    import contextlib
    import io
    import threading

    from gpu_radix_sort_tpu_torch.benchmarks import run_out_of_core as rooc
    from gpu_radix_sort_tpu_torch.ops import binning as bn
    from gpu_radix_sort_tpu_torch.ops import block_sort as bs
    from gpu_radix_sort_tpu_torch.ops import digit_sort as ds
    from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
    from gpu_radix_sort_tpu_torch.ops import onesweep as osw
    from gpu_radix_sort_tpu_torch.ops import single_block as sb
    from gpu_radix_sort_tpu_torch.parallel import storage_sort as ss

    counters = {"onesweep": osw, "block_sort": bs, "merge_level": ms, "digit_sort": ds,
                "binning": bn, "single_block_sort": sb}
    expect = dict.fromkeys(counters, 0)
    if not payload_bytes:
        expect["binning"] = (32 // OOC_WIDTH) * nworker * -(-OOC_WIDTH // bn.PASS_WIDTH)
    argv = ["--rows", str(rows), "--payload-bytes", str(payload_bytes), "--width",
            str(OOC_WIDTH), "--nworker", str(nworker), "--mount", mount]
    what = f"{rows} rows of {4 + payload_bytes} bytes, w{OOC_WIDTH}, {nworker} workers"
    used0 = shutil.disk_usage(mount).used
    peaks = {"rss": proc_bytes("/proc/self/status", "VmRSS"), "disk": 0}
    stop = threading.Event()

    def sample() -> None:
        while not stop.wait(0.2):
            peaks["rss"] = max(peaks["rss"], proc_bytes("/proc/self/status", "VmRSS"))
            peaks["disk"] = max(peaks["disk"], shutil.disk_usage(mount).used - used0)

    sampler = threading.Thread(target=sample, daemon=True)
    parts = dict.fromkeys(("staging", "file reads", "device sorts", "bucket writes",
                           "proof"), 0.0)

    def timed(name: str, fn, sync: bool = False):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if sync:
                    torch.cuda.synchronize()
                parts[name] += time.perf_counter() - t
        return call

    wrapped = [(rooc, "stage_input", "staging", False), (rooc, "verify_stream", "proof", False),
               (ss, "fetch_part_refs_u32", "file reads", False),
               (ss, "fetch_part_refs", "file reads", False),
               (ss, "sort_partial_counts", "device sorts", True),
               (ss, "_digit_order_counts", "device sorts", True),
               (ss, "_write_buckets", "bucket writes", False)]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in wrapped]
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    sampler.start()
    try:
        for mod, attr, name, sync in wrapped:
            setattr(mod, attr, timed(name, getattr(mod, attr), sync))
        for mod in counters.values():
            mod.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = rooc.main(argv)
        secs = time.perf_counter() - t0
    finally:
        stop.set()
        sampler.join()
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
    got = {k: mod.launches for k, mod in counters.items()}
    lines = out.getvalue().strip().splitlines()
    log(f"out-of-core [{card}]: {what}: exit {rc}; its line: {out.getvalue().strip()}")
    if rc != 0 or len(lines) != 1 or json.loads(lines[0])["exact"] is not True:
        fail(f"out-of-core {what}: exit {rc}, not exact")
    if got != expect:
        fail(f"out-of-core {what}: launches {got}, expected {expect}")
    res = json.loads(lines[0])
    workers_s = res["phases"]["workers"]["total_s"]
    parts["workers' rest"] = workers_s - sum(
        parts[k] for k in ("file reads", "device sorts", "bucket writes"))
    res.update(launches={k: v for k, v in got.items() if v}, run_s=secs, breakdown_s=parts,
               peak_rss_gib=peaks["rss"] / GiB, peak_disk_gib=peaks["disk"] / GiB,
               peak_device_gib=(torch.cuda.max_memory_allocated() - held) / GiB,
               nworker=nworker, card=card)
    phases = ", ".join(f"{k} {v['total_s']:.3f}" for k, v in res["phases"].items()
                       if isinstance(v, dict))
    log(f"time [{card}]: out-of-core {what}: {secs:.1f} s in all, sort {res['sort_s']} s "
        f"({res['rows_per_s']} rows/s, host clock), phases (s): {phases}; breakdown (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + "; launches "
        f"{res['launches']}; peaks: host resident {res['peak_rss_gib']:.2f} GiB, disk "
        f"{res['peak_disk_gib']:.2f} GiB over its start (sampled every 0.2 s), device "
        f"{res['peak_device_gib']:.2f} GiB")
    return res


def out_of_core_path(card: str) -> dict:
    """Step 15: the runner at its two configurations' widths and cut rows
    (N_OOC_KEYS keys, N_OOC_KV rows of 64-byte payloads), OOC_WORKERS
    workers, its mount removed after."""
    mount = os.path.join(os.path.dirname(os.path.abspath(__file__)), OOC_DIR)
    shutil.rmtree(mount, ignore_errors=True)
    os.makedirs(mount)
    try:
        return {ooc_name(rows, pb): ooc_run(card, mount, rows, pb, OOC_WORKERS)
                for rows, pb in ((N_OOC_KEYS, 0), (N_OOC_KV, 64))}
    finally:
        shutil.rmtree(mount, ignore_errors=True)


# -- the multi-process mesh (parallel/multihost.py) --------------------------

N_MULTIHOST = N_PART  # the four-rank rows' 256Mi PCG32 keys, 64Mi a rank
N_MULTIHOST_CARDS = 1 << 30  # --all-cards: 256Mi a card, the reference's size a device
MULTIHOST_RANKS = 4  # ranks a mesh of one card: four processes of one, two of two
MULTIHOST_DIR = "_multihost_smoke"  # the children's oracles (listed in .gitignore)
MULTIHOST_TIMEOUT_S = 420  # a phase's children, all told
GLOO_STAGED_REPS = 1  # timed calls of a gloo row that stages its keys: seconds a call
MULTIHOST_KERNELS = ("onesweep", "block_sort", "merge_level", "binning", "segment_copy",
                     "group_sort_send")
# the paths of the multi-process phases and the kernels each must launch (the
# shards' full sorts lie above ONESWEEP_MIN_N)
MULTIHOST_REQUIRED = {
    "lsd alltoall": ("onesweep",),
    "lsd rdma": ("segment_copy", "onesweep"),
    "lsd rdma_overlap": ("group_sort_send", "binning"),
    "sample sort": ("onesweep",),
    "sample merge": ("onesweep", "merge_level"),
    "aggregate count": ("onesweep", "binning"),
}
PEER_PATHS = ("lsd rdma", "lsd rdma_overlap")  # B6 and B7 into other processes' buffers
# every collective of torch.distributed, counted in the children (the podscale guard)
COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_reduce", "all_to_all",
               "all_to_all_single", "barrier", "broadcast", "gather", "reduce",
               "reduce_scatter", "reduce_scatter_tensor", "scatter", "send", "recv")


def write_sorted_keys(n: int, path: str) -> str:
    """np.sort of Pcg32().fill(n) saved to ``path`` (run in a
    :func:`side_pool`): the children's oracle, read by memory map."""
    from gpu_radix_sort_tpu_torch.utils import keygen

    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, np.sort(keygen.Pcg32().fill(n)))
    return path


def multihost_files(root: str, agg=None, want: np.ndarray | None = None) -> dict:
    """The children's oracles under ``root``: the Zipf(1.2) keys and their
    np.unique (``agg``, a :func:`aggregate_inputs` result) and the sorted
    256Mi keys (``want``, where the caller holds them)."""
    os.makedirs(root, exist_ok=True)
    files = {}
    if want is not None:
        files[want.size] = os.path.join(root, f"sorted_{want.size}.npy")
        np.save(files[want.size], want)
    if agg is not None:
        for name, a in zip(("zipf", "uniq", "counts"), agg):
            files[name] = os.path.join(root, f"{name}.npy")
            np.save(files[name], a)
    return files


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_children(spec: dict, world: int, local_ranks: list, what: str) -> list:
    """Runs ``world`` processes of :func:`multihost_child` (process p on
    cuda:local_ranks[p]) as torchrun would start them, and returns their
    results; a child that fails or outlives MULTIHOST_TIMEOUT_S fails the
    phase, and every child is stopped before this returns."""
    from concurrent.futures import ThreadPoolExecutor

    port = free_port()
    procs = []
    try:
        for p in range(world):
            env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       WORLD_SIZE=str(world), RANK=str(p), LOCAL_RANK=str(local_ranks[p]))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--multihost-child",
                 json.dumps(spec)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        with ThreadPoolExecutor(world) as pool:
            futures = [pool.submit(p.communicate, timeout=MULTIHOST_TIMEOUT_S) for p in procs]
            outs = [f.result() for f in futures]
    except subprocess.TimeoutExpired:
        # the children dumped their stacks shortly before (faulthandler)
        tails = []
        for p, proc in enumerate(procs):
            proc.kill()
            stdout, stderr = proc.communicate()
            tails.append(f"process {p}:\n{stdout[-2000:]}\n{stderr[-4000:]}")
        fail(f"{what}: a child outlived {MULTIHOST_TIMEOUT_S} s\n" + "\n".join(tails))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for p, (proc, (stdout, stderr)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in stdout.splitlines() if ln.startswith("MULTIHOST_RESULT ")]
        if proc.returncode != 0 or len(lines) != 1:
            fail(f"{what}: process {p} exited {proc.returncode}\n{stdout[-3000:]}\n"
                 f"{stderr[-6000:]}")
        results.append(json.loads(lines[0].split(" ", 1)[1]))
    return results


def barrier_ms(fn, dev, side, reps: int, warmup: int = 1) -> float:
    """Median host-clock milliseconds of ``fn()`` across the processes: a
    barrier, the call, a synchronise of this process's card, a barrier."""
    import statistics

    import torch.distributed as dist

    samples = []
    for i in range(warmup + reps):
        dist.barrier(group=side)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        dist.barrier(group=side)
        if i >= warmup:
            samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def peer_staged_bytes(path: str, n_local: int, L: int, P: int) -> int:
    """What a peer-memory LSD sort at width 8 stages through host memory in
    a process over gloo: each of its 4 rounds gathers the digit counts (256
    int32 a rank for rdma; a group of the largest tile for rdma_overlap)
    from the L local ranks to the host and all P back, and the overflow
    count's sum goes out and back.  No key."""
    from gpu_radix_sort_tpu_torch.parallel import rdma_overlap as ov

    per_rank = 256 * 4 * (1 if path == "lsd rdma" else n_local // ov.pick_tile(n_local))
    return 4 * (L + P) * per_rank + 2 * 8


def peer_round(path: str, shards: list, mesh, peers=None):
    """A function that runs one exchange round (digit 0..7) of the path's
    kernel over this process's ``shards`` on ``mesh``, without the
    reassembly: B6 on shards digit-sorted here, once, or B7; into ``peers``
    (a process-group mesh) or new receive buffers (a single controller)."""
    from gpu_radix_sort_tpu_torch.ops.radix_sort import sort_by_digits
    from gpu_radix_sort_tpu_torch.parallel import rdma_exchange as rx
    from gpu_radix_sort_tpu_torch.parallel import rdma_overlap as ov

    if path == "lsd rdma":
        sorted_ = [sort_by_digits(s, 0, 8) for s in shards]
        return lambda: rx.exchange_round_rdma_raw(sorted_, 0, 8, mesh, peers)
    tile = ov.pick_tile(shards[0].numel())
    return lambda: ov.exchange_round_rdma_overlapped_raw(shards, 0, 8, tile=tile, mesh=mesh,
                                                         peers=peers)


def check_raw_rounds(mesh, dev) -> int:
    """The process-group raw rounds of B6 and B7 (receive buffers before
    the reassembly) byte for byte against the single controller's on
    ``mesh.size`` ranks of ``dev`` in this process, keys with Zipf(1.3)
    digits (bits 8-15) made alike in every process, the receive buffers
    aligned and at word offsets 1-3 (staggered by rank), B6 at
    check_segment_alignment's n_local.  Returns the buffers compared."""
    from gpu_radix_sort_tpu_torch.ops.radix_sort import sort_by_digits
    from gpu_radix_sort_tpu_torch.parallel import mesh as pm
    from gpu_radix_sort_tpu_torch.parallel import rdma_exchange as rx
    from gpu_radix_sort_tpu_torch.parallel import rdma_overlap as ov
    from gpu_radix_sort_tpu_torch.parallel.peer_memory import PeerBuffers

    P, first, L = mesh.size, mesh.first, len(mesh.devices)
    single = pm.key_mesh([dev] * P)
    rng = np.random.default_rng(16)
    compared = 0
    for kernel, n_local in (("B6", 3 * rx.COPY_CHUNK + 5), ("B7", 3 * ov.MAX_TILE)):
        skewed = dict(exchange_inputs(rng, P * n_local))["skewed"]
        x = torch.from_numpy(skewed).to(dev)
        if kernel == "B6":
            every = [sort_by_digits(s, 8, 8) for s in pm.shard(x, single)]
            want = rx.exchange_round_rdma_raw(every, 8, 8)[1]
        else:
            every = pm.shard(x, single)
            want = ov.exchange_round_rdma_overlapped_raw(every, 8, 8, tile=ov.MAX_TILE)
        mine = every[first:first + L]
        for offsets in (None, [1 + g % 3 for g in mesh.ranks]):
            peers = PeerBuffers(mesh, n_local, offsets=offsets)
            if kernel == "B6":
                got = rx.exchange_round_rdma_raw(mine, 8, 8, mesh, peers)[1]
            else:
                got = ov.exchange_round_rdma_overlapped_raw(mine, 8, 8, tile=ov.MAX_TILE,
                                                            mesh=mesh, peers=peers)
            if [g.data_ptr() % 16 for g in got] != [4 * o for o in offsets or [0] * L]:
                fail(f"raw {kernel} round: receive buffers not at the word offsets {offsets}")
            same_bytes(got, want[first:first + L],
                       f"raw {kernel} round on the process-group mesh (global ranks "
                       f"{list(mesh.ranks)}, offsets {offsets})")
            compared += L
            del peers, got
    return compared


def multihost_child(spec: dict) -> int:
    """One process of the multi-process mesh (``--multihost-child``): joins
    the group that torchrun's variables name, holds ``spec["ranks"]`` ranks
    of cuda:LOCAL_RANK, and for each size and path of ``spec`` drives the
    path's build function once with the launch counts and the
    torch.distributed calls counted, checks its ranks exactly against the
    memory-mapped numpy oracles, and times it (CUDA events beside the
    single-controller mesh of the same ranks and torch.sort where
    ``spec["events"]``, else the host clock through barriers).  Prints one
    MULTIHOST_RESULT line."""
    import faulthandler

    import torch.distributed as dist

    from gpu_radix_sort_tpu_torch.kernels import build
    from gpu_radix_sort_tpu_torch.ops import binning as bn
    from gpu_radix_sort_tpu_torch.ops import block_sort as bs
    from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
    from gpu_radix_sort_tpu_torch.ops import onesweep as osw
    from gpu_radix_sort_tpu_torch.ops import radix_sort as rs
    from gpu_radix_sort_tpu_torch.parallel import distributed as pd
    from gpu_radix_sort_tpu_torch.parallel import mesh as pm
    from gpu_radix_sort_tpu_torch.parallel import pipeline as pp
    from gpu_radix_sort_tpu_torch.parallel import rdma_exchange as rx
    from gpu_radix_sort_tpu_torch.parallel import rdma_overlap as ov
    from gpu_radix_sort_tpu_torch.parallel import sample_sort as ss
    from gpu_radix_sort_tpu_torch.parallel.multihost import initialize_distributed, pod_key_mesh
    from gpu_radix_sort_tpu_torch.parallel.peer_memory import PeerBuffers
    from gpu_radix_sort_tpu_torch.utils import keygen, timers

    counters = dict(zip(MULTIHOST_KERNELS, (osw, bs, ms, bn, rx, ov)))
    faulthandler.dump_traceback_later(MULTIHOST_TIMEOUT_S - 30)  # a hang shows where it is
    initialize_distributed(backend=spec["backend"])
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    build.load()
    mesh = pod_key_mesh([dev] * spec["ranks"])
    W, L, P, first = mesh.processes, len(mesh.devices), mesh.size, mesh.first
    side = dist.new_group(backend="gloo")  # barriers and checks beside the sorts
    res = {"process": dist.get_rank(), "world": W, "ranks": L, "backend": spec["backend"],
           "device": str(dev), "sizes": {}}

    def local_shards(a) -> list:
        m = a.shape[0] // P
        return [torch.from_numpy(np.array(a[g * m:(g + 1) * m])).to(dev)
                for g in range(first, first + L)]

    def counted(call):
        """(the result of one call, its launches, its torch.distributed calls,
        its bytes staged through host memory)"""
        calls = [0]
        saved = {name: getattr(dist, name) for name in COLLECTIVES if hasattr(dist, name)}
        for name, f in saved.items():
            setattr(dist, name, lambda *a, _f=f, **k: (calls.__setitem__(0, calls[0] + 1),
                                                      _f(*a, **k))[1])
        for mod in counters.values():
            mod.launches = 0
        staged = pm.staged_bytes
        try:
            out = call()
            torch.cuda.synchronize(dev)
        finally:
            for name, f in saved.items():
                setattr(dist, name, f)
        return (out, {k: m.launches for k, m in counters.items()}, calls[0],
                pm.staged_bytes - staged)

    def check_sorted(what, bufs, counts, want):
        starts = np.concatenate([[0], np.cumsum(counts)])
        if starts[-1] != want.size:
            fail(f"{what}: the ranks hold {starts[-1]} keys of {want.size}")
        for i, b in enumerate(bufs):
            g = first + i
            got = b[:counts[g]].cpu().numpy()
            if not np.array_equal(got, want[starts[g]:starts[g + 1]]):
                fail(f"{what}: global rank {g} differs from np.sort")

    def gathered_counts(counts) -> np.ndarray:
        return pm.all_gather([c.view(1).to(torch.int64) for c in counts],
                             mesh)[0].view(-1).cpu().numpy()

    t0 = time.perf_counter()
    res["raw_rounds"] = check_raw_rounds(mesh, dev)
    res["raw_rounds_s"] = time.perf_counter() - t0
    for n, paths in spec["sizes"]:
        n_local = n // P
        keys_np = keygen.Pcg32().fill(n)
        shards = local_shards(keys_np)
        del keys_np
        want = np.load(spec["files"][str(n)], mmap_mode="r")
        runs = {}
        for path in paths:
            if path.startswith("lsd"):
                def build_fn(m, n_local=n_local, exchange=path.split()[1]):
                    fn = pd.build_distributed_sort(m, n_local, width=8, exchange=exchange,
                                                   capacity_factor=1.5)
                    return lambda: fn(shards)
            elif path.startswith("sample"):
                def build_fn(m, n_local=n_local, r=path.split()[1]):
                    fn, _ = ss.build_sample_sort(m, n_local, capacity_factor=1.5, reassembly=r)
                    return lambda: fn(shards)
            else:
                zipf = np.load(spec["files"]["zipf"], mmap_mode="r")
                a_local = zipf.size // P
                agg_args = (local_shards(zipf), [torch.ones(a_local, dtype=torch.float32,
                                                            device=dev)] * L,
                            [torch.ones(a_local, dtype=torch.bool, device=dev)] * L)

                def build_fn(m, a_local=a_local, agg_args=agg_args):
                    fn, _ = pp.build_hash_aggregate(m, a_local, op="count")
                    return lambda: fn(*agg_args)
            call = build_fn(mesh)
            out, launches, calls, staged = counted(call)
            what = f"{path}, {n} keys, {W} x {L} ranks over {spec['backend']}, process {first // L}"
            if int(out[-1]) != 0:
                fail(f"{what}: overflow {int(out[-1])}")
            if path.startswith("lsd"):
                check_sorted(what, out[0], np.full(P, n_local), want)
            elif path.startswith("sample"):
                check_sorted(what, out[0], gathered_counts(out[1]), want)
            else:
                uniq = np.load(spec["files"]["uniq"], mmap_mode="r")
                counts = np.load(spec["files"]["counts"], mmap_mode="r")
                gk, ga, ng = out[0], out[1], [int(c) for c in out[2]]
                seen = np.zeros(uniq.size, np.int32)
                for i, (k, a, c) in enumerate(zip(gk, ga, ng)):
                    k, a = k[:c].cpu().numpy(), a[:c].cpu().numpy()
                    idx = np.minimum(np.searchsorted(uniq, k), uniq.size - 1)
                    if (c > 1 and not (k[1:] > k[:-1]).all()) or not (
                            np.array_equal(uniq[idx], k)
                            and np.array_equal(counts[idx], a.astype(np.int64))):
                        fail(f"{what}: global rank {first + i}'s groups differ from np.unique")
                    seen += np.bincount(idx, minlength=uniq.size).astype(np.int32)
                seen = pm.psum([torch.from_numpy(seen).to(dev)], mesh).cpu().numpy()
                if not (seen == 1).all():
                    fail(f"{what}: {int((seen == 0).sum())} groups missing, "
                         f"{int((seen > 1).sum())} repeated")
            if any(launches[k] == 0 for k in MULTIHOST_REQUIRED[path]):
                fail(f"{what}: a kernel of the path was not launched: {launches}")
            if path in PEER_PATHS and spec["backend"] != "nccl" and (
                    staged != peer_staged_bytes(path, n_local, L, P)):
                fail(f"{what}: {staged} bytes staged through host memory, the digit counts "
                     f"alone are {peer_staged_bytes(path, n_local, L, P)}")
            del out
            row = {"launches": launches, "collective_calls": calls, "staged_bytes": staged}
            if spec["backend"] == "nccl":
                syncs = host_syncs(call)
                row["host_syncs"] = syncs
                if syncs:
                    fail(f"{what}: host waits inside the call: {syncs}")
            if spec["events"]:
                # W = 1: this process's ranks are the whole mesh, so the
                # single-controller mesh of the same ranks takes the same shards
                single = build_fn(pm.key_mesh([dev] * L))
                _, row["single_launches"], _, _ = counted(single)
                if row["single_launches"] != launches:
                    fail(f"{what}: launches {launches}, the single-controller mesh's "
                         f"{row['single_launches']}")
                # the counted calls and the sync check were the warmup
                torch.cuda.reset_peak_memory_stats(dev)
                row["ms"] = timers.time_cuda(call, warmup=0)
                row["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
                row["single_ms"] = timers.time_cuda(single, warmup=1)
                del single
            else:
                row["reps"] = spec["reps"] if path in PEER_PATHS else spec.get(
                    "staged_reps", spec["reps"])
                row["ms"] = barrier_ms(call, dev, side, row["reps"], warmup=0)
            del call
            if path in PEER_PATHS:  # one exchange round alone, into the sort's kind of buffers
                one = peer_round(path, shards, mesh, PeerBuffers(mesh, n_local))
                if spec["events"]:
                    row["round_ms"] = timers.time_cuda(one)
                    row["single_round_ms"] = timers.time_cuda(
                        peer_round(path, shards, pm.key_mesh([dev] * L)))
                else:
                    row["round_ms"] = barrier_ms(one, dev, side, spec["reps"])
                del one
            torch.cuda.empty_cache()
            runs[path] = row
        if spec["events"]:
            joined = torch.cat(shards)
            runs["torch.sort"] = {"ms": timers.time_cuda(
                lambda: rs.sort_full(joined, strategy="torch"))}
            del joined
        res["sizes"][str(n)] = runs
        del shards
        torch.cuda.empty_cache()
    dist.barrier(group=side)
    dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()
    print("MULTIHOST_RESULT " + json.dumps(res), flush=True)
    return 0


def multihost_path(card: str, files: dict) -> dict:
    """The multi-process mesh on one card: (1) one process over NCCL,
    world size 1, holding four ranks of cuda:0, CUDA-event medians of 10
    beside the single-controller key_mesh([cuda:0] * 4) and torch.sort of
    the same keys; (2) two processes of two ranks of cuda:0 over gloo, their
    collectives staged through host memory, host-clock medians of 3 (of
    GLOO_STAGED_REPS for the rows that stage their keys).  Each
    path (the LSD sort at w8 through alltoall at capacity 1.5, rdma and
    rdma_overlap, whose B6 and B7 store into the other process's receive
    buffers through CUDA IPC in (2); PSRS "sort" and "merge"; the count
    aggregate of the 256Mi Zipf(1.2) keys) is exact against numpy in every
    process, with its launches and its torch.distributed calls counted,
    which must not grow with the ranks a process holds; each process first
    holds the raw rounds of B6 and B7 against the single controller's.
    Then dryrun_multichip(8) on eight ranks of cuda:0.  Returns the results
    for the JSON line."""
    from gpu_radix_sort_tpu_torch.dryrun import dryrun_multichip

    paths = ["lsd alltoall", *PEER_PATHS, "sample sort", "sample merge", "aggregate count"]
    base = {"files": {str(k): v for k, v in files.items()},
            "sizes": [[N_MULTIHOST, paths]]}
    res = {}
    t0 = time.perf_counter()
    (one,) = run_children(dict(base, backend="nccl", ranks=MULTIHOST_RANKS, events=True),
                          1, [0], "multihost phase 1 (NCCL, one process)")
    res["nccl_1x4"] = one["sizes"][str(N_MULTIHOST)]
    res["nccl_1x4_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = run_children(dict(base, backend="gloo", ranks=MULTIHOST_RANKS // 2, events=False,
                            reps=3, staged_reps=GLOO_STAGED_REPS), 2, [0, 0],
                       "multihost phase 2 (gloo, two processes)")
    res["gloo_2x2"] = two[0]["sizes"][str(N_MULTIHOST)]
    res["gloo_2x2_launches"] = {
        path: [r["sizes"][str(N_MULTIHOST)][path]["launches"] for r in two] for path in paths}
    res["gloo_2x2_s"] = time.perf_counter() - t0
    res["raw_rounds"] = {"nccl_1x4": one["raw_rounds"], "gloo_2x2": [r["raw_rounds"] for r in two]}
    log(f"multihost: raw rounds of B6 and B7 on the process-group mesh (receive buffers "
        f"aligned and at word offsets 1-3, Zipf(1.3) digits) equal to the single "
        f"controller's byte for byte: {one['raw_rounds']} buffers in the NCCL process "
        f"({one['raw_rounds_s']:.1f} s), {[r['raw_rounds'] for r in two]} in the gloo "
        f"processes, whose stores reach each other through CUDA IPC "
        f"({max(r['raw_rounds_s'] for r in two):.1f} s)")
    for path in paths:
        a, b = res["nccl_1x4"][path], res["gloo_2x2"][path]
        total = {k: sum(r["sizes"][str(N_MULTIHOST)][path]["launches"][k] for r in two)
                 for k in MULTIHOST_KERNELS}
        calls = {r["sizes"][str(N_MULTIHOST)][path]["collective_calls"] for r in two}
        if total != a["launches"] or calls != {a["collective_calls"]}:
            fail(f"multihost {path}: two processes launch {total} with {calls} collective "
                 f"calls, one process {a['launches']} with {a['collective_calls']}")
        log(f"time [{card}]: multihost {path}, {N_MULTIHOST} keys on 4 ranks of cuda:0, exact: "
            f"1 process x 4 ranks over NCCL {a['ms']:.3f} ms (CUDA events, median of 10; "
            f"single-controller mesh {a['single_ms']:.3f} ms; peak {a['peak_mib']:.0f} MiB); "
            f"2 processes x 2 ranks over gloo {b['ms']:.3f} ms (host clock, median of "
            f"{b['reps']}; "
            f"{b['staged_bytes']} bytes staged through host memory a process); "
            f"launches {a['launches']}; {a['collective_calls']} torch.distributed calls a "
            f"process at 1 x 4 and 2 x 2; host waits inside the NCCL call: "
            f"{len(a['host_syncs'])}")
        if path in PEER_PATHS:
            log(f"time [{card}]: multihost {path}: one exchange round (digit 0-7, no "
                f"reassembly) 1 x 4 over NCCL {a['round_ms']:.3f} ms (CUDA events; single "
                f"controller {a['single_round_ms']:.3f} ms); 2 x 2 over gloo through IPC "
                f"{b['round_ms']:.3f} ms (host clock); launches a gloo process "
                f"{[r[MULTIHOST_REQUIRED[path][0]] for r in res['gloo_2x2_launches'][path]]} "
                f"{MULTIHOST_REQUIRED[path][0]}; beside the same children's gloo alltoall "
                f"{res['gloo_2x2']['lsd alltoall']['ms']:.3f} ms")
    log(f"time [{card}]: torch.sort (strategy='torch') of the same {N_MULTIHOST} keys "
        f"{res['nccl_1x4']['torch.sort']['ms']:.3f} ms; multihost phases "
        f"{res['nccl_1x4_s']:.1f} s + {res['gloo_2x2_s']:.1f} s")
    t0 = time.perf_counter()
    res["dryrun_8"] = dryrun_multichip(8)
    res["dryrun_8_s"] = time.perf_counter() - t0
    log(f"dryrun_multichip(8) on eight ranks of cuda:0: {len(res['dryrun_8'])} checks exact "
        f"in {res['dryrun_8_s']:.1f} s")
    return res


def multihost_cards_path(devs: list, card: str, files: dict, single: dict) -> dict:
    """``--all-cards``: four processes, one card each, over NCCL
    (pod_key_mesh() in each), the LSD sort (alltoall, and rdma and
    rdma_overlap, whose B6 and B7 store across the cards into the other
    processes' buffers through CUDA IPC) and PSRS at 256Mi and 1Gi keys in
    all and the count aggregate of the 256Mi Zipf keys, exact, host-clock
    medians of 10 through barriers, beside the single-controller mesh of the
    same cards (``single``: its time and launches of each path at 256Mi from
    :func:`all_cards_path`, which the processes' launches must add up to;
    at 1Gi its times measured here); each process first holds the raw
    rounds of B6 and B7 across the cards against the single controller's."""
    from gpu_radix_sort_tpu_torch.parallel import distributed as dist
    from gpu_radix_sort_tpu_torch.parallel import sample_sort as ss
    from gpu_radix_sort_tpu_torch.parallel.mesh import key_mesh, shard
    from gpu_radix_sort_tpu_torch.utils import keygen

    P = len(devs)
    sorts = ["lsd alltoall", *PEER_PATHS, "sample sort", "sample merge"]
    # the single-controller mesh of the same cards at 1Gi
    mesh = key_mesh(devs)
    n_local = N_MULTIHOST_CARDS // P
    shards = shard(torch.from_numpy(keygen.Pcg32().fill(N_MULTIHOST_CARDS)), mesh)
    single_big = {
        **{path: dist.build_distributed_sort(mesh, n_local, width=8, exchange=path.split()[1],
                                             capacity_factor=1.5)
           for path in ("lsd alltoall", *PEER_PATHS)},
        "sample sort": ss.build_sample_sort(mesh, n_local, capacity_factor=1.5)[0],
        "sample merge": ss.build_sample_sort(mesh, n_local, capacity_factor=1.5,
                                             reassembly="merge")[0],
    }
    single_big = {k: synced_ms(lambda fn=fn: fn(shards), devs) for k, fn in single_big.items()}
    del shards
    for d in devs:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()
    spec = {"backend": "nccl", "ranks": 1, "events": False, "reps": 10,
            "files": {str(k): v for k, v in files.items()},
            "sizes": [[N_MULTIHOST, sorts + ["aggregate count"]], [N_MULTIHOST_CARDS, sorts]]}
    t0 = time.perf_counter()
    results = run_children(spec, P, list(range(P)), f"multihost across {P} cards")
    res = {"seconds": time.perf_counter() - t0, "processes": results[0]["sizes"],
           "single_1Gi_ms": single_big, "raw_rounds": [r["raw_rounds"] for r in results]}
    log(f"multihost across {P} cards: raw rounds of B6 and B7 equal to the single "
        f"controller's byte for byte, {res['raw_rounds']} buffers a process (stores across "
        f"the cards through CUDA IPC)")
    for n, paths in spec["sizes"]:
        for path in paths:
            rows = [r["sizes"][str(n)][path] for r in results]
            if len({r["collective_calls"] for r in rows}) != 1:
                fail(f"multihost across cards {path}: collective calls differ by process")
            total = {k: sum(r["launches"][k] for r in rows) for k in MULTIHOST_KERNELS}
            if n == N_MULTIHOST and total != single[path][1]:
                fail(f"multihost across cards {path}: the processes launch {total}, the "
                     f"single-controller mesh {single[path][1]}")
            base = single[path][0] if n == N_MULTIHOST else single_big[path]
            log(f"time [{card}]: multihost {path}, {n} keys, {P} processes x 1 card over NCCL, "
                f"exact: {rows[0]['ms']:.3f} ms (host clock through barriers, median of 10); "
                f"single-controller mesh of the {P} cards {base:.3f} ms; launches a process "
                + "; ".join(f"{[r['launches'][k] for r in rows]} {k}" for k in MULTIHOST_KERNELS
                            if any(r["launches"][k] for r in rows))
                + f"; {rows[0]['collective_calls']} torch.distributed calls; host waits "
                f"{sum(len(r['host_syncs']) for r in rows)}"
                + (f"; one round {[round(r['round_ms'], 3) for r in rows]} ms"
                   if path in PEER_PATHS else ""))
    return res


# The onesweep sort's exactness sizes: two small, the benchmark's 256Mi, the
# mesh rounds' received flat of 320Mi + 256 keys, and the storage plane's
# 2^29; its crossover sweep against the merge route.
N_ONESWEEP = (1 << 15, 1 << 20, 1 << 28, 5 * (1 << 26) + 256, 1 << 29)
N_ONESWEEP_TIMED = (1 << 28, 5 * (1 << 26) + 256)
N_CROSSOVER = tuple(1 << k for k in range(15, 23))


def full_sort_launches(m: int, sorts: int = 1) -> dict:
    """Kernel launches of ``sorts`` calls of sort_full on m keys each, by
    the route ``_resolve`` gives m: the onesweep sort, or the tile pass and
    its merge levels, or one block."""
    from gpu_radix_sort_tpu_torch.ops import block_sort as bs
    from gpu_radix_sort_tpu_torch.ops import onesweep as osw
    from gpu_radix_sort_tpu_torch.ops import radix_sort as rs

    route = rs._resolve(None, m)
    if route == "onesweep":
        return {"onesweep": sorts * osw.LAUNCHES}
    if route == "merge":
        return {"block_sort": sorts, "merge_level": sorts * ((m - 1) // bs.TILE).bit_length()}
    return {"single_block_sort": sorts}


def launches_sum(*parts: dict) -> dict:
    """The launch counts of several calls, kernel by kernel."""
    total: dict = {}
    for part in parts:
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    return total


def onesweep_keys(n: int, kind: str, gen, dev, offset: int = 0) -> torch.Tensor:
    """n keys of a kind on the card, starting ``offset`` words past a
    16-byte boundary: uniform; all equal; 0 and 0xFFFFFFFF; uniform with 20%
    slack keys of 0xFFFFFFFF (the mesh rounds' received flat); four values
    of every byte."""
    buf = torch.empty(n + 4, dtype=torch.int32, device=dev)
    x = buf[offset:offset + n]
    if kind == "equal":
        x.fill_(0x1E3779B9)
        return x.view(torch.uint32)
    x.random_(-(1 << 31), 1 << 31, generator=gen)
    if kind == "zero-max":
        x.copy_(torch.where(x < 0, -1, 0))
    elif kind == "slack20":
        x.masked_fill_(torch.rand(n, device=dev, generator=gen) < 0.2, -1)
    elif kind == "few":
        x.copy_((x & 3) * 0x41414141)
    return x.view(torch.uint32)


def ms_text(v: float | None) -> str:
    """A time for the log, or "not measured"."""
    return "not measured" if v is None else f"{v:.3f} ms"


def as_u64(x: torch.Tensor) -> torch.Tensor:
    """uint32 keys as int64 values, for differences."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def sorted_by_library(x: torch.Tensor) -> torch.Tensor:
    """torch.sort of the order-isomorphic int32 view (the yardstick)."""
    return (torch.sort(x.view(torch.int32) ^ (-(1 << 31))).values ^ (-(1 << 31))).view(
        torch.uint32)


def onesweep_path(dev, card: str, lib) -> dict:
    """The onesweep sort: its geometry against the wrapper's, exactness
    against torch.sort and its plain version at N_ONESWEEP (every input
    word offset, several kinds of keys), its times beside its bound, its
    plain version, torch.sort and the merge route, a profile by kernel, the
    crossover sweep against the merge route, and the launches of the
    sort_full paths it serves.  Returns the results for the JSON line."""
    import ctypes

    import gpu_radix_sort_tpu_torch as port
    from gpu_radix_sort_tpu_torch.kernels import build
    from gpu_radix_sort_tpu_torch.ops import block_sort as bs
    from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
    from gpu_radix_sort_tpu_torch.ops import onesweep as osw
    from gpu_radix_sort_tpu_torch.ops import radix_sort as rs
    from gpu_radix_sort_tpu_torch.ops import single_block as sb
    from gpu_radix_sort_tpu_torch.parallel.mesh import key_mesh
    from gpu_radix_sort_tpu_torch.utils import timers

    tile, header = ctypes.c_int(0), ctypes.c_int(0)
    build.check(lib.grs_onesweep_geometry(ctypes.byref(tile), ctypes.byref(header)),
                "onesweep geometry")
    if (tile.value, header.value) != (osw.TILE, osw.HEADER_WORDS):
        fail(f"onesweep geometry {tile.value}, {header.value} != the wrapper's "
             f"{osw.TILE}, {osw.HEADER_WORDS}")
    gen = torch.Generator(device=dev).manual_seed(24)
    res: dict = {"tile": osw.TILE}

    # -- exactness ---------------------------------------------------------
    t0 = time.perf_counter()
    cases = err = 0
    for n in N_ONESWEEP:
        kinds = (("random", "equal", "zero-max", "slack20", "few") if n <= 1 << 20
                 else ("random", "slack20"))
        for kind in kinds:
            for offset in range(4):
                x = onesweep_keys(n, kind, gen, dev, offset)
                before = x.clone()
                got = osw.sort_full_onesweep(x)
                want = sorted_by_library(x)
                err = max(err, int((as_u64(got) - as_u64(want)).abs().max()))
                if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
                    fail(f"onesweep n={n} {kind} offset={offset}: {bad} keys differ "
                         f"from torch.sort")
                if not torch.equal(x.view(torch.int32), before.view(torch.int32)):
                    fail(f"onesweep n={n} {kind} offset={offset} wrote its input")
                cases += 1
                del x, before, got, want
        if n <= 1 << 20:
            x = onesweep_keys(n, "random", gen, dev)
            if not torch.equal(osw.sort_full_onesweep(x).view(torch.int32),
                               osw.sort_full_onesweep_plain(x).view(torch.int32)):
                fail(f"onesweep n={n} differs from its plain version")
            cases += 1
        torch.cuda.empty_cache()
        log(f"onesweep: n={n} exact ({time.perf_counter() - t0:.1f} s so far)")
    log(f"onesweep: {cases} cases equal to torch.sort byte for byte (n in {N_ONESWEEP}; "
        f"input at word offsets 0-3 past a 16-byte boundary; random/equal/zero-max/"
        f"slack20/few at n <= 2^20, random/slack20 above; the input unwritten), and to "
        f"the plain version at 2^15 and 2^20, in {time.perf_counter() - t0:.1f} s")
    res["exact_cases"], res["max_abs_err"] = cases, err

    # -- times ---------------------------------------------------------------
    for n in N_ONESWEEP_TIMED:
        x = onesweep_keys(n, "random", gen, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        osw.sort_full_onesweep(x)
        torch.cuda.synchronize()
        scratch_mib = (torch.cuda.max_memory_allocated() - held) / 2**20 - 2 * n * 4 / 2**20
        t_kernel = timers.time_cuda(lambda: osw.sort_full_onesweep(x), iters=20)
        t_merge = timers.time_cuda(lambda: ms.sort_full_large(x), iters=5)
        t_lib = timers.time_cuda(lambda: torch.sort(x.view(torch.int32)), iters=5)
        t_plain = timers.time_cuda(lambda: osw.sort_full_onesweep_plain(x), warmup=1, iters=3)
        b, b_alg = bound(8 * n, 0), bound(36 * n, 0)
        prof = kernel_launches_ms(lambda: osw.sort_full_onesweep(x))
        kinds = {"histogram": "onesweep_histogram_kernel", "pass": "onesweep_pass_kernel"}
        per_launch, seen = {}, {}
        for key, kname in kinds.items():
            ts = [t for name, v in (prof or {}).items() if kname in name for t in v]
            per_launch[key] = float(np.mean(ts)) if ts else None
            seen[key] = len(ts)
        kernel_sum = (per_launch["histogram"] + osw.PASSES * per_launch["pass"]
                      if all(per_launch.values()) else None)
        res[f"n={n}"] = {
            "ms": t_kernel, "bound_ms": b[0], "bound_by": b[1],
            "algorithm_bound_ms": b_alg[0], "plain_ms": t_plain,
            "library_ms": t_lib, "merge_route_ms": t_merge,
            "histogram_ms": per_launch["histogram"], "pass_ms": per_launch["pass"],
            "launches_profiled": seen,
            "kernel_sum_ms": kernel_sum,
            "scratch_mib": scratch_mib, "scratch_words_mib": osw.scratch_words(n) * 4 / 2**20}
        log(f"time [{card}]: onesweep of {n} keys {t_kernel:.3f} ms (bound {b[0]:.3f} ms "
            f"for a key read and written once, {100 * b[0] / t_kernel:.1f}%; the algorithm's "
            f"36 bytes a key {b_alg[0]:.3f} ms, {100 * b_alg[0] / t_kernel:.1f}%); by kernel "
            f"(profiler, mean a launch over {seen} launches of 5 sorts): histogram "
            f"{ms_text(per_launch['histogram'])}, a pass {ms_text(per_launch['pass'])} (bound "
            f"{b[0]:.3f}); histogram + {osw.PASSES} passes {ms_text(kernel_sum)} "
            f"against the event time {t_kernel:.3f} ms; merge route {t_merge:.3f} ms; "
            f"torch.sort {t_lib:.3f} ms; plain {t_plain:.3f} ms; scratch beyond the two "
            f"buffers {scratch_mib:.3f} MiB")
        del x
        torch.cuda.empty_cache()

    # -- the crossover sweep ---------------------------------------------------
    sweep = {}
    for n in N_CROSSOVER:
        x = onesweep_keys(n, "random", gen, dev)
        t_os = timers.time_cuda(lambda: osw.sort_full_onesweep(x), warmup=3, iters=30)
        t_ms = timers.time_cuda(lambda: ms.sort_full_large(x), warmup=3, iters=30)
        t_lib = timers.time_cuda(lambda: sorted_by_library(x), warmup=3, iters=30)
        sweep[n] = {"onesweep_ms": t_os, "merge_ms": t_ms, "torch_sort_ms": t_lib}
        log(f"crossover [{card}]: n=2^{n.bit_length() - 1}: onesweep {t_os:.4f} ms, "
            f"merge route {t_ms:.4f} ms, torch.sort {t_lib:.4f} ms (CUDA events, a call "
            f"with its host work, median of 30)")
    res["crossover"] = sweep
    wins = [n for n in N_CROSSOVER if sweep[n]["onesweep_ms"] < sweep[n]["merge_ms"]]
    first_win = next((n for n in N_CROSSOVER if all(m in wins for m in N_CROSSOVER if m >= n)),
                     None)
    res["crossover_first_win"] = first_win
    log(f"crossover: onesweep faster from n={first_win} on (ONESWEEP_MIN_N is "
        f"{rs.ONESWEEP_MIN_N})")

    # -- the sort_full paths it serves, with their launches -------------------
    counters = {"onesweep": osw, "block_sort": bs, "merge_level": ms, "single_block_sort": sb}

    def launched(fn) -> dict:
        for mod in counters.values():
            mod.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: mod.launches for k, mod in counters.items() if mod.launches}

    x = onesweep_keys(1 << 29, "random", gen, dev)
    out, got = launched(lambda: rs.sort_full(x))
    if got != full_sort_launches(1 << 29):
        fail(f"sort_full of 2^29 keys launched {got}, expected {full_sort_launches(1 << 29)}")
    if not torch.equal(out.view(torch.int32), sorted_by_library(x).view(torch.int32)):
        fail("sort_full of 2^29 keys differs from torch.sort")
    paths = {"sort_full 2^29": got}
    del x, out
    x = onesweep_keys(N_PART, "random", gen, dev)
    out, got = launched(lambda: rs.sort_partial(x, 0, 8, stable=False)[0])
    if got != full_sort_launches(N_PART):
        fail(f"sort_partial(stable=False) launched {got}")
    paths["sort_partial(0, 8, stable=False) 256Mi"] = got
    for m in (rs.ONESWEEP_MIN_N - 1, rs.ONESWEEP_MIN_N):
        out, got = launched(lambda: rs.sort_full(x[:m]))
        if got != full_sort_launches(m):
            fail(f"sort_full of {m} keys launched {got}, expected {full_sort_launches(m)}")
        paths[f"sort_full {m}"] = got
    mesh4 = key_mesh([dev] * MESH_RANKS)
    out, got = launched(lambda: port.sort_distributed(x, mesh=mesh4, width=8))
    nsteps = 32 // 8
    if not torch.equal(out.view(torch.int32), sorted_by_library(x).view(torch.int32)):
        fail("sort_distributed on four ranks differs from torch.sort")
    paths["sort_distributed w8, 4 ranks of one card"] = got
    log(f"onesweep: launches on its paths {paths} (sort_distributed: {nsteps + 1} sorts a "
        f"rank, {MESH_RANKS} ranks)")
    res["launches"] = paths
    del x, out
    torch.cuda.empty_cache()
    return res


def onesweep_main() -> int:
    """``--onesweep``: the kernels' build and the onesweep sort alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from gpu_radix_sort_tpu_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    ptxas = start_ptxas_report()
    lib = build.load()
    log(f"build: {build.library_path().name} ready in {time.perf_counter() - t_start:.2f} s")
    info = {name: lines for name, lines in ptxas_report(ptxas).items() if "onesweep" in name}
    for name, lines in info.items():
        log(f"ptxas [{name}]: {'; '.join(lines)}")
    occupancy = blocks_per_sm(lib, "grs_onesweep_blocks_per_sm")
    log(f"occupancy [onesweep_pass_kernel]: {occupancy[0]} blocks a SM with {occupancy[1]} "
        f"bytes of dynamic shared memory")
    res = onesweep_path(torch.device("cuda", 0), card, lib)
    print(json.dumps({"onesweep": res, "ptxas": info, "blocks_per_sm": occupancy,
                      "card": card}))
    log(f"chip_smoke --onesweep: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def log_profile(card: str, what: str, fn, top: int = 8) -> None:
    """Profile ``fn`` (device_profile) and log its device time a call, its
    idle share and the ``top`` kernels that took most."""
    prof = device_profile(fn)
    if prof is None:
        log(f"profile [{card}]: {what}: the profiler saw no device work (not measured)")
        return
    by_name, idle = prof
    total = sum(by_name.values())
    log(f"profile [{card}]: {what}: device {total:.3f} ms a call over 3 calls, idle "
        f"share {idle:.4f}; top:")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {t:8.3f} ms {100 * t / total:5.1f}%  {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    from gpu_radix_sort_tpu_torch.kernels import build
    from gpu_radix_sort_tpu_torch.ops import binning as bn
    from gpu_radix_sort_tpu_torch.ops import block_sort as bs
    from gpu_radix_sort_tpu_torch.ops import digit_sort as ds
    from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
    from gpu_radix_sort_tpu_torch.ops import onesweep as osw
    from gpu_radix_sort_tpu_torch.ops import radix_sort as rs
    from gpu_radix_sort_tpu_torch.ops import single_block as sb
    from gpu_radix_sort_tpu_torch.ops.bits import sortable_digits, to_int64
    from gpu_radix_sort_tpu_torch.utils import checks, keygen, timers

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    zipf_pool, zipf_keys = start_zipf_keys(N_PART)
    agg_inputs = zipf_pool.submit(aggregate_inputs, N_AGG)

    t0 = time.perf_counter()
    ptxas = start_ptxas_report()
    lib = build.load()
    log(f"build: {build.library_path().name} ready in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    rank_info = {name: {"ptxas": lines} for name, lines in ptxas_report(ptxas).items()}
    rank_info["digit_sort_kernel"]["blocks_per_sm"] = {
        f"n={ds.MAX_N_KV} w{w}": blocks_per_sm(lib, "grs_digit_sort_blocks_per_sm", ds.MAX_N_KV, w)
        for w in (8, 17)}
    rank_info["block_sort_kernel"]["blocks_per_sm"] = {
        f"tile={tile}": blocks_per_sm(lib, "grs_block_sort_blocks_per_sm", tile)
        for tile in (bs.TILE, 512)}
    rank_info["merge_level_kernel"]["blocks_per_sm"] = {
        f"{ms.B_OUT} keys a block": blocks_per_sm(lib, "grs_merge_level_blocks_per_sm")}
    rank_info["onesweep_pass_kernel"]["blocks_per_sm"] = {
        f"{osw.TILE} keys a block": blocks_per_sm(lib, "grs_onesweep_blocks_per_sm")}
    rank_info["group_sort_send_kernel"]["blocks_per_sm"] = {
        f"tile={1 << 14} w8 {what}": blocks_per_sm(
            lib, "grs_group_sort_send_blocks_per_sm", 1 << 14, 8, nranks)
        for what, nranks in (("send to 4 ranks", 4), ("sort-only", 0))}
    for name, info in rank_info.items():
        log(f"ptxas [{name}]: {'; '.join(info['ptxas'])}")
        if "blocks_per_sm" in info:
            log(f"occupancy [{name}]: " + "; ".join(
                f"{what}: {b} blocks a SM with {smem} bytes of dynamic shared memory"
                for what, (b, smem) in info["blocks_per_sm"].items()))

    TILE = bs.TILE
    rng = np.random.default_rng(1)

    def on_card(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def inputs(n: int, duplicate: bool = False):
        yield "random", rng.integers(0, 1 << 32, n, dtype=np.uint32)
        yield "equal", np.full(n, 0x9E3779B9, np.uint32)
        yield "all-max", np.full(n, 0xFFFFFFFF, np.uint32)
        if duplicate:  # four values of every 8-bit window, other bits random
            few = rng.integers(0, 4, n, dtype=np.uint32) * np.uint32(0x41414141)
            yield "duplicate", few ^ (rng.integers(0, 1 << 32, n, dtype=np.uint32)
                                      & np.uint32(0x18181818))

    def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> int:
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = int((to_int64(got) - to_int64(want)).abs().max()) if got.numel() else 0
        if err:
            fail(f"{what}: kernel differs from its plain version (max abs err {err})")
        return err

    # -- block_sort against its plain version ------------------------------
    small_n = (1, 1000, 1024, TILE - 1, TILE)
    # a ragged last tile after an even and after an odd number of whole
    # tiles, each of every tile size below
    ragged_n = tuple(k * TILE + TILE // 3 for k in (4, 5))
    block_tiles = (1, 2, 128, 512, TILE)
    err_block, cases = 0, 0
    for n in small_n + ragged_n:
        for tile in sorted({bs.next_pow2(n) if n <= TILE else TILE, *block_tiles[:-1]}):
            for alternate in (False, True):
                for name, a in inputs(n, duplicate=True):
                    x = on_card(a)
                    err_block = max(err_block, compare(
                        bs.block_sort(x, tile, alternate=alternate),
                        bs.block_sort_plain(x, tile, alternate=alternate),
                        f"block_sort n={n} tile={tile} alternate={alternate} {name}",
                    ))
                    cases += 1
    big = on_card(rng.integers(0, 1 << 32, N_MAIN, dtype=np.uint32))
    big_ns = (N_MAIN, (N_MAIN // TILE - 2) * TILE + 777, (N_MAIN // TILE - 1) * TILE + 777)
    for n in big_ns:
        err_block = max(err_block, compare(
            bs.block_sort(big[:n], TILE, alternate=True),
            bs.block_sort_plain(big[:n], TILE, alternate=True),
            f"block_sort n={n} tile={TILE} alternate=True",
        ))
        cases += 1
    log(f"block_sort: {cases} cases equal to the plain version byte for byte "
        f"(n in {small_n + ragged_n} at tiles {block_tiles[:-1]} and the next power "
        f"of two; n in {big_ns} at {TILE}; alternate on/off; random/equal/all-max/"
        f"duplicate)")

    # -- single_block_sort against its plain version ----------------------------
    err_single, cases = 0, 0
    single_ns = (1, 2, 3, 16, 31, 511, 512, 513, 1000, 1024, 2047, 4096, 4099, 8192,
                 12345, TILE - 1, TILE)
    for n in single_ns:
        for name, a in inputs(n, duplicate=True):
            # the keys as given (16-byte aligned), then one key past that
            # (key-by-key loads and stores)
            for shift in (0, 1):
                x = on_card(np.concatenate([np.zeros(shift, np.uint32), a]))[shift:]
                err_single = max(err_single, compare(
                    sb.sort_single_block(x), sb.sort_single_block_plain(x),
                    f"single_block_sort n={n} shift={shift} {name}"))
                cases += 1
    log(f"single_block_sort: {cases} cases equal to the plain version byte for byte "
        f"(n in {single_ns}; random/equal/all-max/duplicate; input aligned and "
        f"shifted by one key)")

    # -- merge_level against its plain version -----------------------------
    err_merge, cases = 0, 0
    merge_ls = (1, 3, 128, 1000, 4099, ms.B_OUT)

    def shifted(runs: torch.Tensor, shift: int) -> torch.Tensor:
        """runs starting ``shift`` keys past a 16-byte boundary."""
        x = torch.empty(runs.numel() + 4, dtype=runs.dtype, device=dev)[shift:]
        return x[:runs.numel()].copy_(runs)

    for n in small_n + ragged_n[:1]:
        for L in merge_ls:
            for name, a in inputs(n, duplicate=True):
                runs = bs.sort_runs_plain(on_card(a), L, alternate=True)
                want = ms.merge_level_plain(runs, L)
                for shift in (0, 1, 2, 3) if name == "random" else (0,):
                    err_merge = max(err_merge, compare(
                        ms.merge_level(shifted(runs, shift), L), want,
                        f"merge_level n={n} L={L} {name} input shift {shift}",
                    ))
                    cases += 1
    for L in (TILE, 1 << 20, N_MAIN // 2):
        runs = bs.sort_runs_plain(big, L, alternate=True)
        err_merge = max(err_merge, compare(
            ms.merge_level(runs, L), ms.merge_level_plain(runs, L),
            f"merge_level n={N_MAIN} L={L}",
        ))
        cases += 1
    del runs
    log(f"merge_level: {cases} cases equal to the plain version byte for byte "
        f"(L in {merge_ls} at n in {small_n + ragged_n[:1]}, random/equal/all-max/"
        f"duplicate, random input also 1-3 keys past a 16-byte boundary; L in "
        f"{(TILE, 1 << 20, N_MAIN // 2)} at n={N_MAIN})")

    # -- digit_sort against its plain version --------------------------------
    err_digit, cases = 0, 0
    digit_ns = (1, 1000, ds.MAX_N_KV - 1, ds.MAX_N_KV)
    digit_widths = (1, 4, 8, 16, 17)
    for n in digit_ns:
        for w in digit_widths:
            for offset in sorted({0, (11 * w) % (33 - w), 32 - w}):
                for name, a in inputs(n, duplicate=True):
                    x = on_card(a)
                    err_digit = max(err_digit, compare(
                        ds.sort_by_digits_small(x, offset, w),
                        ds.sort_by_digits_small_plain(x, offset, w),
                        f"digit_sort n={n} offset={offset} width={w} {name}",
                    ))
                    cases += 1
    log(f"digit_sort: {cases} cases equal to the plain version byte for byte "
        f"(n in {digit_ns}; widths {digit_widths} at three offsets; "
        f"random/equal/all-max/duplicate)")

    # -- binning against its plain version, on the same stage-A output -------
    def bin_compare(x, cols, offset, w, tile, what):
        sk, scols, g_run, sflat = bn.stage_a(x, cols, offset, w, tile)
        err = 0
        for src in (sk, *scols):
            err = max(err, compare(
                bn.bin_runs(sk, src, g_run, sflat, tile, offset, w),
                bn.bin_runs_plain(sk, src, g_run, sflat, tile, offset, w), what,
            ))
        return err

    err_bin, cases = 0, 0
    bin_ns = (1, 7, 1000, bn.TILE - 1, bn.TILE, bn.TILE + 1, 100003)
    bin_windows = ((0, 4), (28, 4), (5, 3), (8, 8))
    for n in bin_ns:
        col = on_card(np.arange(n, dtype=np.uint32))
        for offset, w in bin_windows:
            for name, a in inputs(n):
                err_bin = max(err_bin, bin_compare(
                    on_card(a), (col,), offset, w, bn.auto_geometry(n),
                    f"binning n={n} offset={offset} width={w} {name}",
                ))
                cases += 1
    log(f"binning: {cases} cases, keys and one column each, equal to the plain "
        f"version byte for byte (n in {bin_ns}; windows {bin_windows}; "
        f"random/equal/all-max)")

    # -- the sort_full path ----------------------------------------------------
    keygen.reset_global_stream()
    keys_np = keygen.generate_keys(N_MAIN)
    keys = on_card(keys_np)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    bs.launches = ms.launches = ds.launches = bn.launches = sb.launches = osw.launches = 0
    t0 = time.perf_counter()
    out = rs.sort_full(keys)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {"onesweep": osw.launches, "block_sort": bs.launches,
                "merge_level": ms.launches}
    if ds.launches or bn.launches or sb.launches:
        fail(f"sort_full launched digit_sort {ds.launches}, binning {bn.launches}, "
             f"single_block_sort {sb.launches}")
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
    want_launches = {**dict.fromkeys(launches, 0), **full_sort_launches(N_MAIN)}
    log(f"main path: sort_full of {N_MAIN} PCG32 keys, launches {launches} "
        f"(expected {want_launches}); first call {first_ms:.1f} ms by host "
        f"clock; peak device memory {peak_mib:.0f} MiB above the "
        f"{keys.numel() * 4 / 2**20:.0f} MiB of keys")
    if launches != want_launches:
        fail(f"main path launches {launches}, expected {want_launches}")
    if not checks.check_sort_full(out.cpu().numpy(), keys_np):
        fail("sort_full of 64M keys differs from np.sort")
    log("main path: exact against np.sort")

    n_ragged = N_MAIN - 12345
    out = rs.sort_full(keys[:n_ragged])
    if not checks.check_sort_full(out.cpu().numpy(), keys_np[:n_ragged]):
        fail(f"sort_full of {n_ragged} keys differs from np.sort")
    del out

    bs.launches = ms.launches = sb.launches = 0
    n_small = TILE - 3
    out = rs.sort_full(keys[:n_small])
    single_launches = sb.launches
    if (sb.launches, bs.launches, ms.launches) != (1, 0, 0):
        fail(f"n={n_small} took {sb.launches} single-block, {bs.launches} block and "
             f"{ms.launches} merge launches; expected one single-block launch")
    if not checks.check_sort_full(out.cpu().numpy(), keys_np[:n_small]):
        fail(f"sort_full of {n_small} keys differs from np.sort")

    n_typed = 1 << 22
    ints = keys_np[:n_typed].view(np.int32)
    if not np.array_equal(rs.sort_full(on_card(ints)).cpu().numpy(), np.sort(ints)):
        fail("int32 sort_full differs from np.sort")
    floats = keys_np[n_typed:2 * n_typed].view(np.float32)
    got = rs.sort_full(on_card(floats)).cpu().numpy()
    if not np.array_equal(total_order_np(got), np.sort(total_order_np(floats))):
        fail("float32 sort_full differs from the numpy totalOrder sort")

    n_part = 1 << 20
    s, b = rs.sort_partial(keys[:n_part], 8, 8, stable=False)
    s, b = s.cpu().numpy(), b.cpu().numpy()
    if not checks.check_partial_groups(s, keys_np[:n_part], 8, 8):
        fail("sort_partial(stable=False) breaks the digit-group contract")
    if not np.array_equal(b, checks.boundaries_oracle(s, 8, 8)):
        fail("sort_partial boundaries differ from boundaries_oracle")
    log(f"routes: ragged n={n_ragged} exact; n={n_small} one block exact "
        f"(single_block_sort launches {single_launches}); "
        f"int32 and float32 at {n_typed} exact; sort_partial(8, 8, stable=False) "
        f"at {n_part} meets the group and boundary contract")

    # -- times of the sort_full path ------------------------------------------
    ms_sort = timers.time_cuda(lambda: rs.sort_full(keys))
    ms_torch = timers.time_cuda(lambda: rs.sort_full(keys, strategy="torch"))
    ms_block = timers.time_cuda(lambda: bs.block_sort(keys, TILE, alternate=True))
    ms_block_plain = timers.time_cuda(
        lambda: bs.block_sort_plain(keys, TILE, alternate=True))
    rows = keys.view(torch.int32).view(-1, TILE)
    ms_block_lib = timers.time_cuda(lambda: torch.sort(rows, dim=1))
    runs = bs.block_sort(keys, TILE, alternate=True)
    ms_merge = timers.time_cuda(lambda: ms.merge_level(runs, TILE))
    ms_merge_plain = timers.time_cuda(lambda: ms.merge_level_plain(runs, TILE))
    pairs = runs.view(torch.int32).view(-1, 2 * TILE)
    ms_merge_lib = timers.time_cuda(lambda: torch.sort(pairs, dim=1))
    one_block = keys[:TILE]
    flipped = sortable_digits(one_block, 0, 32)  # the int32 view that torch.sort takes
    one_out = torch.empty_like(one_block)

    def counting_route() -> None:  # digit_sort_kernel by all 32 bits: four 8-bit passes
        build.check(lib.grs_digit_sort_u32(
            one_block.data_ptr(), one_out.data_ptr(), TILE, 0, 32,
            torch.cuda.current_stream().cuda_stream), "digit_sort by 32 bits")

    counting_route()
    compare(one_out, sb.sort_single_block_plain(one_block), "one-block counting route")
    ms_single = graph_ms(lambda: sb.sort_single_block(one_block))
    ms_single_lib = graph_ms(lambda: torch.sort(flipped))
    ms_single_count = graph_ms(counting_route)
    ms_single_call = timers.time_cuda(lambda: sb.sort_single_block(one_block))
    ms_single_lib_call = timers.time_cuda(lambda: torch.sort(flipped))
    ms_single_count_call = timers.time_cuda(counting_route)
    ms_single_plain = timers.time_cuda(lambda: sb.sort_single_block_plain(one_block))
    top = bs.sort_runs_plain(keys, N_MAIN // 2, alternate=True)
    ms_merge_top = timers.time_cuda(lambda: ms.merge_level(top, N_MAIN // 2))
    rate = lambda t: N_MAIN / (t * 1e-3)  # noqa: E731
    log(f"time [{card}]: sort_full {N_MAIN} keys {ms_sort:.3f} ms "
        f"({rate(ms_sort):.4g} keys/s); median of 10 by CUDA events")
    log(f"time [{card}]: torch.sort (strategy='torch') {ms_torch:.3f} ms "
        f"({rate(ms_torch):.4g} keys/s)")
    log(f"time [{card}]: block_sort pass (tile {TILE}) {ms_block:.3f} ms; "
        f"plain {ms_block_plain:.3f} ms; torch.sort of the rows {ms_block_lib:.3f} ms")
    log(f"time [{card}]: merge_level L={TILE} {ms_merge:.3f} ms; plain "
        f"{ms_merge_plain:.3f} ms; torch.sort of the (n/2L, 2L) rows "
        f"{ms_merge_lib:.3f} ms; L={N_MAIN // 2} {ms_merge_top:.3f} ms "
        f"({2 * 4 * N_MAIN / (ms_merge * 1e-3) / 1e9:.4g} GB/s moved at L={TILE})")
    log(f"time [{card}]: single_block_sort of {TILE} keys {ms_single:.4f} ms a launch "
        f"(a CUDA graph of 20 calls), torch.sort of the int32 view {ms_single_lib:.4f} ms "
        f"a call; design study: four 8-bit counting passes (digit_sort_kernel) "
        f"{ms_single_count:.4f} ms; single calls by CUDA events, host work included: "
        f"{ms_single_call:.4f} ms, torch.sort {ms_single_lib_call:.4f} ms, counting "
        f"{ms_single_count_call:.4f} ms, plain {ms_single_plain:.4f} ms")
    block_bound = bound(8 * N_MAIN, N_MAIN // 2 * network_stages(TILE))
    single_bound = bound(8 * TILE, TILE // 2 * network_stages(TILE))
    merge_bound = bound(8 * N_MAIN, N_MAIN)
    log_profile(card, f"sort_full of {N_MAIN} keys", lambda: rs.sort_full(keys), top=6)
    del keys, keys_np, big, out, runs, pairs, top, rows, one_block, ints, floats, got, s, b
    del flipped, one_out
    torch.cuda.empty_cache()

    # -- the stable partial-sort path ------------------------------------------
    stream = keygen.Pcg32()  # the global stream from its start; the storage path goes on
    t0 = time.perf_counter()
    part_np = stream.fill(N_PART)
    part = on_card(part_np)
    torch.cuda.synchronize()
    log(f"partial path: {N_PART} PCG32 keys made and moved to the card in "
        f"{time.perf_counter() - t0:.1f} s")
    held = torch.cuda.memory_allocated()
    part_launches, peak_part = {}, 0.0
    for w in PART_WIDTHS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bs.launches = ms.launches = ds.launches = bn.launches = 0
        t0 = time.perf_counter()
        s_dev, b_dev = rs.sort_partial(part, 0, w)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        got = {"block_sort": bs.launches, "merge_level": ms.launches,
               "digit_sort": ds.launches, "binning": bn.launches}
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        peak_part = max(peak_part, peak)
        passes = -(-w // bn.PASS_WIDTH)
        want_launches = {"block_sort": 0, "merge_level": 0, "digit_sort": 0,
                         "binning": passes}
        if got != want_launches:
            fail(f"sort_partial(0, {w}) launches {got}, expected {want_launches}")
        part_launches[w] = got["binning"]
        want = checks.partial_sort_oracle(part_np, 0, w)
        if not np.array_equal(s_dev.cpu().numpy(), want):
            fail(f"stable sort_partial(0, {w}) of {N_PART} keys differs from the "
                 f"numpy stable oracle")
        if not np.array_equal(b_dev.cpu().numpy(), checks.boundaries_oracle(want, 0, w)):
            fail(f"sort_partial(0, {w}) boundaries differ from boundaries_oracle")
        del s_dev, b_dev
        _, c_dev = rs.sort_partial_counts(part, 0, w)
        if not np.array_equal(c_dev.cpu().numpy().astype(np.int64),
                              checks.true_bucket_counts(part_np, 0, w)):
            fail(f"sort_partial_counts(0, {w}) differs from true_bucket_counts")
        del c_dev, want
        log(f"partial path: stable sort_partial(0, {w}) of {N_PART} keys exact "
            f"(keys, boundaries, counts); launches {got}; first call "
            f"{first_ms:.1f} ms by host clock; peak device memory {peak:.0f} MiB "
            f"above the {N_PART * 4 / 2**20:.0f} MiB of keys")

    vals = torch.arange(N_PART, dtype=torch.int32, device=dev).view(torch.uint32)
    bs.launches = ms.launches = ds.launches = bn.launches = 0
    sk, sv = rs.sort_key_value_by_digits(part, vals, 8, 4)
    torch.cuda.synchronize()
    kv_launches = bn.launches
    if (bs.launches, ms.launches, ds.launches, kv_launches) != (0, 0, 0, 2):
        fail(f"kv digit sort launched block_sort {bs.launches}, merge_level "
             f"{ms.launches}, digit_sort {ds.launches}, binning {kv_launches}; "
             f"expected binning 2 (keys and the column) and no other")
    order = np.argsort(checks.extract_digits(part_np, 8, 4).astype(np.uint8),
                       kind="stable")
    if not np.array_equal(sv.cpu().numpy(), order.astype(np.uint32)):
        fail("kv digit sort: values differ from np.argsort(digits, kind='stable')")
    if not np.array_equal(sk.cpu().numpy(), part_np[order]):
        fail("kv digit sort: keys differ from the numpy stable oracle")
    del sk, sv, order
    log(f"partial path: kv sort_key_value_by_digits(8, 4) of {N_PART} keys with "
        f"an arange column exact; binning launches {kv_launches}")

    n_small = ds.MAX_N_KV - 3
    bs.launches = ms.launches = ds.launches = bn.launches = 0
    s_small, b_small = rs.sort_partial(part[:n_small], 0, 8)
    torch.cuda.synchronize()
    small_launches = ds.launches
    if (bs.launches, ms.launches, ds.launches, bn.launches) != (0, 0, 1, 0):
        fail(f"sort_partial of {n_small} keys launched block_sort {bs.launches}, "
             f"merge_level {ms.launches}, digit_sort {ds.launches}, binning "
             f"{bn.launches}; expected digit_sort 1 and no other")
    s_small = s_small.cpu().numpy()
    if not checks.check_partial(s_small, part_np[:n_small], 0, 8):
        fail(f"stable sort_partial of {n_small} keys differs from the oracle")
    if not np.array_equal(b_small.cpu().numpy(), checks.boundaries_oracle(s_small, 0, 8)):
        fail(f"sort_partial of {n_small} keys: boundaries differ")
    log(f"partial path: one-block route, sort_partial(0, 8) of {n_small} keys "
        f"exact; digit_sort launches {small_launches}")

    err_bin = max(err_bin, bin_compare(part, (vals,), 0, 4, bn.TILE,
                                       f"binning n={N_PART} width 4"))
    log(f"binning: n={N_PART} at width 4, keys and one column, equal to the "
        f"plain version byte for byte")

    # -- times of the partial-sort path ----------------------------------------
    ms_part, ms_part_torch, ms_digits = {}, {}, {}
    for w in PART_WIDTHS:
        ms_part[w] = timers.time_cuda(lambda: rs.sort_partial(part, 0, w))
        ms_digits[w] = timers.time_cuda(lambda: rs.sort_by_digits(part, 0, w))
        ms_part_torch[w] = timers.time_cuda(
            lambda: rs.sort_partial(part, 0, w, strategy="torch"))
        log(f"time [{card}]: stable sort_partial(0, {w}) {N_PART} keys "
            f"{ms_part[w]:.3f} ms ({N_PART / (ms_part[w] * 1e-3):.4g} keys/s; "
            f"sort_by_digits alone {ms_digits[w]:.3f} ms); strategy='torch' "
            f"{ms_part_torch[w]:.3f} ms; bound "
            f"{bound(8 * N_PART * -(-w // bn.PASS_WIDTH), 0)[0]:.3f} ms")
    ms_kv = timers.time_cuda(lambda: rs.sort_key_value_by_digits(part, vals, 8, 4))
    ms_kv_torch = timers.time_cuda(
        lambda: rs.sort_key_value_by_digits(part, vals, 8, 4, strategy="torch"))
    log(f"time [{card}]: kv sort_key_value_by_digits(8, 4) {N_PART} pairs "
        f"{ms_kv:.3f} ms; strategy='torch' {ms_kv_torch:.3f} ms; bound "
        f"{bound(16 * N_PART, 0)[0]:.3f} ms")
    ms_stage_a = timers.time_cuda(lambda: bn.stage_a(part, (), 0, 4, bn.TILE))
    sk, _, g_run, sflat = bn.stage_a(part, (), 0, 4, bn.TILE)
    ms_bin = timers.time_cuda(lambda: bn.bin_runs(sk, sk, g_run, sflat, bn.TILE, 0, 4))
    ms_bin_plain = timers.time_cuda(
        lambda: bn.bin_runs_plain(sk, sk, g_run, sflat, bn.TILE, 0, 4))
    # the same (digit, tile, rank) order: a stable sort of stage A's digits
    sk_digits = sortable_digits(sk, 0, 4)
    ms_bin_lib = timers.time_cuda(lambda: torch.sort(sk_digits, stable=True))
    bin_bound = bound(8 * N_PART + 16 * g_run.numel(), N_PART)
    log(f"time [{card}]: one 4-bit pass at {N_PART} keys: stage A (row "
        f"torch.sort, gather, searchsorted, metadata) {ms_stage_a:.3f} ms; binning "
        f"kernel {ms_bin:.3f} ms ({8 * N_PART / (ms_bin * 1e-3) / 1e9:.4g} GB/s "
        f"moved; bound {bin_bound[0]:.3f} ms); plain {ms_bin_plain:.3f} ms; stable "
        f"torch.sort of stage A's digits (no gather) {ms_bin_lib:.3f} ms")
    del sk, g_run, sflat, sk_digits
    x_small = part[:ds.MAX_N_KV]
    d_small, d17 = sortable_digits(x_small, 0, 8), sortable_digits(x_small, 0, 17)
    ms_ds = graph_ms(lambda: ds.sort_by_digits_small(x_small, 0, 8))
    ms_ds_lib = graph_ms(lambda: torch.sort(d_small, stable=True))
    ms_ds17 = graph_ms(lambda: ds.sort_by_digits_small(x_small, 0, 17))
    ms_ds17_lib = graph_ms(lambda: torch.sort(d17, stable=True))
    ms_ds_call = timers.time_cuda(lambda: ds.sort_by_digits_small(x_small, 0, 8))
    ms_ds_lib_call = timers.time_cuda(lambda: torch.sort(d_small, stable=True))
    ms_ds_plain = timers.time_cuda(lambda: ds.sort_by_digits_small_plain(x_small, 0, 8))
    digit_bound = bound(8 * ds.MAX_N_KV, 0)  # a read and a write a key; no network
    log(f"time [{card}]: digit_sort of {ds.MAX_N_KV} keys by 8 bits {ms_ds:.4f} ms a "
        f"launch (a CUDA graph of 20 calls), stable torch.sort of the digits "
        f"{ms_ds_lib:.4f} ms a call; by 17 bits (three passes) {ms_ds17:.4f} ms, its "
        f"torch.sort {ms_ds17_lib:.4f} ms; single calls by CUDA events, host work "
        f"included: {ms_ds_call:.4f} ms, torch.sort {ms_ds_lib_call:.4f} ms, plain "
        f"{ms_ds_plain:.4f} ms; bound {digit_bound[0]:.5f} ms")
    log(f"memory [{card}]: stable sort_partial at {N_PART} keys peaks at "
        f"{peak_part:.0f} MiB above the {N_PART * 4 / 2**20:.0f} MiB of keys")

    for w in (4, 16):
        log_profile(card, f"sort_partial(0, {w}) of {N_PART} keys",
                    lambda: rs.sort_partial(part, 0, w))

    del vals
    torch.cuda.empty_cache()
    steps: dict = {}  # seconds into the script at the end of each step, for its time budget

    def step_done(name: str) -> None:
        steps[name] = time.perf_counter() - t_start
        log(f"step: {name} done {steps[name]:.1f} s into the script")

    step_done("build, kernel checks, sort_full and partial paths")
    onesweep = onesweep_path(dev, card, lib)
    step_done("onesweep sort")
    keep: dict = {}
    kv = kv_table_path(dev, card, part, part_np, zipf_keys, keep)
    step_done("kv, 64-bit and table paths")
    t0 = time.perf_counter()
    want = np.sort(part_np)
    log(f"np.sort of the {N_PART} keys in {time.perf_counter() - t0:.1f} s (the oracle "
        f"of the mesh and sample paths)")
    mesh = mesh_path(dev, rng, card, part, part_np, rank_info["segment_copy_kernel"],
                     rank_info["group_sort_send_kernel"], want)
    step_done("mesh path")
    sample = sample_path(dev, card, part, part_np, want, keep)
    step_done("sample path")
    mh_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), MULTIHOST_DIR)
    mh_files = multihost_files(mh_root, want=want)
    del part, want, keep
    torch.cuda.empty_cache()
    aggregate = aggregate_path(dev, card, agg_inputs)
    step_done("aggregate path")
    zipf_pool.shutdown()
    mh_files.update(multihost_files(mh_root, agg=agg_inputs.result()))
    del agg_inputs
    torch.cuda.empty_cache()
    multihost = multihost_path(card, mh_files)
    step_done("multihost phases")
    shutil.rmtree(mh_root, ignore_errors=True)
    storage = storage_path(dev, card, part_np, stream)
    step_done("storage path")
    del part_np
    st_launches = storage["launches"]
    torch.cuda.empty_cache()
    bench = bench_path(dev, card)
    step_done("bench step")
    del bench["records"]  # in chiprun_out/bench_full.jsonl and printed above
    out_of_core = out_of_core_path(card)
    step_done("out-of-core step")

    def on_path(res: dict, kernel_name: str) -> dict:
        return {k: v[kernel_name] for k, v in res["launches"].items() if kernel_name in v}

    def mh_launches(kernel_name: str) -> dict:  # one process of four ranks over NCCL
        return {k: v["launches"][kernel_name] for k, v in multihost["nccl_1x4"].items()
                if "launches" in v}

    mesh_kernels = mesh.pop("kernels")
    for row in mesh_kernels:  # B6 and B7: their launches and rounds on the multihost phases
        path = {"segment_copy": "lsd rdma", "group_sort_send": "lsd rdma_overlap"}[row[0]]
        row[9].update(
            launches_multihost=mh_launches(row[0]),
            launches_multihost_gloo=[r[row[0]] for r in multihost["gloo_2x2_launches"][path]],
            multihost_round_ms=multihost["nccl_1x4"][path]["round_ms"],
            multihost_round_single_ms=multihost["nccl_1x4"][path]["single_round_ms"],
            multihost_round_gloo_ms=multihost["gloo_2x2"][path]["round_ms"])

    def kernel(name, source, replaces, n_launches, err, t, t_plain, b, t_lib, **extra):
        return {"name": name, "route": "cuda",
                "source": f"gpu_radix_sort_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n_launches, "max_abs_err": err,
                "ms": t, "plain_ms": t_plain, "bound_ms": b[0], "bound_by": b[1],
                "library_ms": t_lib, **extra}

    print(json.dumps({"kernels": [
        kernel("block_sort", "block_sort.cu", "gpu_radix_sort_tpu/ops/pallas_merge.py:131",
               launches["block_sort"], err_block, ms_block, ms_block_plain,
               block_bound, ms_block_lib, network="register_bitonic.cuh, windowed",
               launches_group_aggregate=kv["launches"]["group_aggregate count zipf"].get(
                   "block_sort", 0),
               pass_256Mi_ms=mesh["tile_pass_256Mi_ms"],
               launches_mesh_one_rank=mesh["launches_one_rank"]["block_sort"],
               launches_storage={k: v["block_sort"] for k, v in st_launches.items()
                                 if "block_sort" in v},
               launches_sample=on_path(sample, "block_sort"),
               launches_hash_aggregate=on_path(aggregate, "block_sort"),
               launches_bench=on_path(bench, "block_sort"),
               launches_multihost=mh_launches("block_sort"),
               **rank_info["block_sort_kernel"]),
        kernel("single_block_sort", "block_sort.cu", "gpu_radix_sort_tpu/ops/pallas_sort.py:180",
               single_launches, err_single, ms_single, ms_single_plain, single_bound,
               ms_single_lib, timed="CUDA graph of 20 calls", network="register_bitonic.cuh",
               counting_route_ms=ms_single_count,
               single_call_ms=ms_single_call, single_call_library_ms=ms_single_lib_call,
               counting_route_single_call_ms=ms_single_count_call,
               launches_storage={k: v["single_block_sort"] for k, v in st_launches.items()
                                 if "single_block_sort" in v},
               launches_sample=on_path(sample, "single_block_sort"),
               launches_hash_aggregate=on_path(aggregate, "single_block_sort"),
               **rank_info["single_block_sort_kernel<14>"]),
        kernel("merge_level", "merge_path.cu", "gpu_radix_sort_tpu/ops/pallas_merge.py:335",
               launches["merge_level"], err_merge, ms_merge, ms_merge_plain,
               merge_bound, ms_merge_lib, top_level_ms=ms_merge_top,
               launches_group_aggregate=kv["launches"]["group_aggregate count zipf"].get(
                   "merge_level", 0),
               level_256Mi_ms=mesh["merge_level_256Mi_ms"],
               launches_mesh_one_rank=mesh["launches_one_rank"]["merge_level"],
               launches_storage={k: v["merge_level"] for k, v in st_launches.items()
                                 if "merge_level" in v},
               launches_sample=on_path(sample, "merge_level"),
               launches_hash_aggregate=on_path(aggregate, "merge_level"),
               launches_bench=on_path(bench, "merge_level"),
               launches_multihost=mh_launches("merge_level"),
               **rank_info["merge_level_kernel"]),
        kernel("onesweep", "onesweep.cu", None, launches["onesweep"], onesweep["max_abs_err"],
               onesweep[f"n={N_PART}"]["ms"], onesweep[f"n={N_PART}"]["plain_ms"],
               bound(8 * N_PART, 0), onesweep[f"n={N_PART}"]["library_ms"],
               why="sort_full above ONESWEEP_MIN_N keys: 4.5 passes over the keys "
                   "against the merge route's 15 at 256Mi",
               algorithm_bound_ms=onesweep[f"n={N_PART}"]["algorithm_bound_ms"],
               histogram_ms=onesweep[f"n={N_PART}"]["histogram_ms"],
               pass_ms=onesweep[f"n={N_PART}"]["pass_ms"],
               launches_profiled=onesweep[f"n={N_PART}"]["launches_profiled"],
               at_320Mi=onesweep[f"n={5 * (1 << 26) + 256}"],
               exact_cases=onesweep["exact_cases"], crossover=onesweep["crossover"],
               crossover_first_win=onesweep["crossover_first_win"],
               launches_onesweep_paths=onesweep["launches"],
               launches_storage={k: v["onesweep"] for k, v in st_launches.items()
                                 if "onesweep" in v},
               launches_sample=on_path(sample, "onesweep"),
               launches_hash_aggregate=on_path(aggregate, "onesweep"),
               launches_bench=on_path(bench, "onesweep"),
               launches_multihost=mh_launches("onesweep"),
               **rank_info["onesweep_pass_kernel"]),
        kernel("digit_sort", "block_sort.cu", "gpu_radix_sort_tpu/ops/pallas_sort.py:185",
               small_launches, err_digit, ms_ds, ms_ds_plain, digit_bound, ms_ds_lib,
               timed="CUDA graph of 20 calls", w17_ms=ms_ds17, w17_library_ms=ms_ds17_lib,
               single_call_ms=ms_ds_call, single_call_library_ms=ms_ds_lib_call,
               launches_storage={k: v["digit_sort"] for k, v in st_launches.items()
                                 if "digit_sort" in v},
               launches_out_of_core={k: v["launches"].get("digit_sort", 0)
                                     for k, v in out_of_core.items()},
               **rank_info["digit_sort_kernel"]),
        kernel("binning", "binning.cu", "gpu_radix_sort_tpu/ops/pallas_radix.py:205",
               sum(part_launches.values()), err_bin, ms_bin, ms_bin_plain,
               bin_bound, ms_bin_lib, launches_by_width=part_launches,
               kv_launches=kv_launches, stage_a_ms=ms_stage_a,
               launches_kv_u64_table={k: v["binning"] for k, v in kv["launches"].items()
                                      if "binning" in v},
               launches_storage={k: v["binning"] for k, v in st_launches.items()
                                 if "binning" in v},
               launches_sample=on_path(sample, "binning"),
               launches_hash_aggregate=on_path(aggregate, "binning"),
               launches_bench=on_path(bench, "binning"),
               launches_multihost=mh_launches("binning"),
               launches_out_of_core={k: v["launches"].get("binning", 0)
                                     for k, v in out_of_core.items()}),
        *(kernel(*k[:9], **k[9]) for k in mesh_kernels),
    ], "sort_full_ms": ms_sort, "torch_sort_ms": ms_torch, "n": N_MAIN,
        "sort_partial_ms": ms_part, "sort_partial_torch_ms": ms_part_torch,
        "kv_digit_sort_ms": ms_kv, "kv_digit_sort_torch_ms": ms_kv_torch,
        "n_partial": N_PART, "peak_mib_partial": peak_part, "kv_u64_table": kv, **mesh,
        "sample": sample, "aggregate": aggregate, "multihost": multihost, "storage": storage,
        "bench": bench, "out_of_core": out_of_core, "steps_s": steps, "card": card}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def synced_ms(fn, devices: list, iters: int = 10) -> float:
    """Median host-clock milliseconds of ``fn()`` through a synchronise of
    every device: CUDA events on one stream would miss the other cards'
    work."""
    from gpu_radix_sort_tpu_torch.utils import timers

    def run():
        fn()
        for d in devices:
            torch.cuda.synchronize(d)

    return timers.time_wall(run, warmup=2, iters=iters)


def host_syncs(fn) -> list[str]:
    """The calls in ``fn()`` that make the host wait for a card, from
    PyTorch's sync debug mode: a single controller that waits on one card
    cannot enqueue the others' work meanwhile.  (The mode's own notice that
    it is a prototype, given once a process, is not one of them.)"""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{'/'.join(w.filename.split('/')[-3:])}:{w.lineno}" for w in caught
            if "called a synchronizing" in str(w.message)]


def all_cards_main() -> int:
    """``--all-cards``: the mesh sort across every card (see the module
    docstring)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke --all-cards: needs two or more CUDA devices", file=sys.stderr)
        return 1
    from gpu_radix_sort_tpu_torch.kernels import build

    t_start = time.perf_counter()
    cards = card_lines()
    for line in cards:
        log(line)
    pool = side_pool()
    agg_inputs = pool.submit(aggregate_inputs, N_AGG)
    mh_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), MULTIHOST_DIR)
    sort_pool = side_pool(2)
    sorted_keys = {n: sort_pool.submit(write_sorted_keys, n, os.path.join(mh_root, f"sorted_{n}.npy"))
                   for n in (N_MULTIHOST, N_MULTIHOST_CARDS)}
    P = torch.cuda.device_count()
    t0 = time.perf_counter()
    build.load()
    log(f"build: {build.library_path().name} ready in {time.perf_counter() - t0:.2f} s")
    access = [[a == b or torch.cuda.can_device_access_peer(a, b) for b in range(P)]
              for a in range(P)]
    log(f"peer access (row may write column): {access}")
    devs = [torch.device("cuda", i) for i in range(P)]
    res = all_cards_path(devs, cards[0], agg_inputs)
    files = {n: f.result() for n, f in sorted_keys.items()}
    files.update(multihost_files(mh_root, agg=agg_inputs.result()))
    pool.shutdown()
    sort_pool.shutdown()
    single = {path: (res[f"{key}_cards_ms"], res["launches"][launches]) for path, key, launches in (
        ("lsd alltoall", "alltoall", "alltoall"), ("lsd rdma", "rdma", "rdma"),
        ("lsd rdma_overlap", "rdma_overlap", "rdma_overlap"),
        ("sample sort", "sample_sort", "sample sort"),
        ("sample merge", "sample_merge", "sample merge"),
        ("aggregate count", "hash_aggregate", "hash aggregate count"))}
    res["multihost"] = multihost_cards_path(devs, cards[0], files, single)
    shutil.rmtree(mh_root, ignore_errors=True)
    from gpu_radix_sort_tpu_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    res["dryrun"] = dryrun_multichip(P)
    log(f"dryrun_multichip({P}) across the {P} cards: {len(res['dryrun'])} checks exact in "
        f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"all_cards": P, "peer_access": access, **res, "cards": cards}))
    log(f"chip_smoke --all-cards: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def all_cards_path(devs: list, card: str, agg_inputs) -> dict:
    """The checks and times of ``--all-cards`` over the ranks ``devs``, one
    a card (``agg_inputs``, a future of :func:`aggregate_inputs`); returns
    the results for the JSON line."""
    import gpu_radix_sort_tpu_torch as port
    from gpu_radix_sort_tpu_torch.ops import binning as bn
    from gpu_radix_sort_tpu_torch.ops import block_sort as bs
    from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
    from gpu_radix_sort_tpu_torch.ops import onesweep as osw
    from gpu_radix_sort_tpu_torch.ops import radix_sort as rs
    from gpu_radix_sort_tpu_torch.parallel import distributed as dist
    from gpu_radix_sort_tpu_torch.parallel import pipeline as pp
    from gpu_radix_sort_tpu_torch.parallel import rdma_exchange as rx
    from gpu_radix_sort_tpu_torch.parallel import rdma_overlap as ov
    from gpu_radix_sort_tpu_torch.parallel import sample_sort as ss
    from gpu_radix_sort_tpu_torch.parallel.mesh import key_mesh, shard
    from gpu_radix_sort_tpu_torch.utils import keygen

    P = len(devs)
    mesh, one_card = key_mesh(devs), key_mesh([devs[0]] * P)
    cpu_mesh = key_mesh([torch.device("cpu")] * P)

    def sync() -> None:
        for d in devs:
            torch.cuda.synchronize(d)

    # -- B6 and B7 across cards against their plain versions (CPU shards) ----
    rng = np.random.default_rng(1)
    n_check = P << 20
    cases = 0
    for name, a in exchange_inputs(rng, n_check):
        x = torch.from_numpy(a)
        got = rx.exchange_round_rdma_raw(
            [rs.sort_by_digits(s, 8, 8) for s in shard(x, mesh)], 8, 8)[1]
        want = rx.exchange_round_rdma_raw(
            [rs.sort_by_digits(s, 8, 8) for s in shard(x, cpu_mesh)], 8, 8)[1]
        same_bytes(got, want, f"segment_copy across {P} cards, {name}")
        tile = ov.pick_tile(n_check // P)
        for serial in (False, True):
            got = ov.exchange_round_rdma_overlapped(shard(x, mesh), 8, 8, tile=tile,
                                                    serial=serial)[0]
            want = ov.exchange_round_rdma_overlapped(shard(x, cpu_mesh), 8, 8, tile=tile,
                                                     serial=serial)[0]
            same_bytes(got, want, f"group_sort_send across {P} cards, serial={serial}, {name}")
        cases += 3
    n_align = 3 * rx.COPY_CHUNK + 5
    b6_align = check_segment_alignment(devs, rng, n_align)
    log(f"exchange kernels across {P} cards: {cases} rounds (segment_copy; group_sort_send "
        f"overlapped and serial) equal to their plain versions byte for byte "
        f"(n_local={n_check // P}; uniform/duplicate/presorted/skewed/equal); "
        f"segment_copy in {b6_align} launches at every source x receiver word offset "
        f"past a 16-byte boundary (n_local={n_align})")

    # -- the mesh sort of 256Mi keys across the cards ------------------------
    keygen.reset_global_stream()
    part_np = keygen.generate_keys(N_MESH)
    want = np.sort(part_np)
    part = torch.from_numpy(part_np).to(devs[0])
    n_local = N_MESH // P
    counters = {"segment_copy": rx, "group_sort_send": ov, "onesweep": osw,
                "block_sort": bs, "merge_level": ms, "binning": bn}
    nsteps = 32 // 8
    none = dict.fromkeys(counters, 0)
    expected = {
        "rdma": {**none, "segment_copy": nsteps * P,
                 **full_sort_launches(n_local, (nsteps + 1) * P)},
        "rdma_overlap": {**none, "group_sort_send": nsteps * P, "binning": nsteps * P * 2},
        "alltoall": None,  # the collective exchange: exactness only
    }
    launches = {}
    for exchange, expect in expected.items():
        for mod in counters.values():
            mod.launches = 0
        out = port.sort_distributed(part, mesh=mesh, width=8, exchange=exchange)
        sync()
        launches[exchange] = {name: mod.launches for name, mod in counters.items()}
        log(f"all cards: sort_distributed(width=8, exchange={exchange!r}) of {N_MESH} PCG32 "
            f"keys on {P} cards, launches {launches[exchange]}")
        if expect is not None and launches[exchange] != expect:
            fail(f"{exchange} across cards launches {launches[exchange]}, expected {expect}")
        if not np.array_equal(out.cpu().numpy(), want):
            fail(f"sort_distributed {exchange} across {P} cards differs from np.sort")
        del out
    log("all cards: rdma, rdma_overlap and alltoall exact against np.sort")
    cap = ss.default_pair_capacity(n_local, P, 1.5)
    for reassembly in ("sort", "merge"):
        for mod in counters.values():
            mod.launches = 0
        out = port.sort_distributed_sample(part, mesh=mesh, reassembly=reassembly,
                                           fallback=False)
        sync()
        got = {name: mod.launches for name, mod in counters.items()}
        launches[f"sample {reassembly}"] = got
        m = P * cap + n_local
        expect = {**none, **launches_sum(
            full_sort_launches(n_local, P),
            full_sort_launches(m, P) if reassembly == "sort"
            else {"merge_level": P * ((m - 1) // cap).bit_length()})}
        log(f"all cards: sort_distributed_sample(reassembly={reassembly!r}) of {N_MESH} "
            f"PCG32 keys on {P} cards, launches {got}")
        if got != expect:
            fail(f"sample sort {reassembly} across cards launches {got}, expected {expect}")
        if not np.array_equal(out.cpu().numpy(), want):
            fail(f"sort_distributed_sample {reassembly} across {P} cards differs from np.sort")
        del out
    log("all cards: the sample sort, both reassemblies, exact against np.sort")
    del want

    # -- times: across the cards, and the same work on P ranks of cuda:0 ------
    res = {"launches": launches, "n_mesh": N_MESH}
    shards_cards, shards_one = shard(part, mesh), shard(part, one_card)
    for exchange in expected:
        fn_one = dist.build_distributed_sort(one_card, n_local, width=8, exchange=exchange)
        fn_cards = dist.build_distributed_sort(mesh, n_local, width=8, exchange=exchange)
        res[f"{exchange}_one_card_ms"] = synced_ms(lambda: fn_one(shards_one), devs)
        res[f"{exchange}_cards_ms"] = synced_ms(lambda: fn_cards(shards_cards), devs)
        syncs = host_syncs(lambda: fn_cards(shards_cards))
        res[f"{exchange}_host_syncs"] = len(syncs)
        log(f"time [{card}]: sort_distributed {exchange}, {N_MESH} keys, {P} ranks: "
            f"{P} cards {res[f'{exchange}_cards_ms']:.3f} ms; one card "
            f"{res[f'{exchange}_one_card_ms']:.3f} ms (host clock through a synchronise "
            f"of every card, median of 10); {len(syncs)} host synchronisations in a "
            f"sort{': ' if syncs else ''}{'; '.join(sorted(set(syncs))[:3])}")

    for reassembly in ("sort", "merge"):
        fn_one = ss.build_sample_sort(one_card, n_local, reassembly=reassembly)[0]
        fn_cards = ss.build_sample_sort(mesh, n_local, reassembly=reassembly)[0]
        key = f"sample_{reassembly}"
        res[f"{key}_one_card_ms"] = synced_ms(lambda: fn_one(shards_one), devs)
        res[f"{key}_cards_ms"] = synced_ms(lambda: fn_cards(shards_cards), devs)
        syncs = host_syncs(lambda: fn_cards(shards_cards))
        res[f"{key}_host_syncs"] = len(syncs)
        log(f"time [{card}]: sample sort ({reassembly}), {N_MESH} keys, {P} ranks: {P} "
            f"cards {res[f'{key}_cards_ms']:.3f} ms; one card {res[f'{key}_one_card_ms']:.3f} "
            f"ms (host clock through a synchronise of every card, median of 10); "
            f"{len(syncs)} host synchronisations in a sort"
            f"{': ' if syncs else ''}{'; '.join(sorted(set(syncs))[:3])}")

    for where, shards in (("one_card", shards_one), ("cards", shards_cards)):
        res[f"b6_round_{where}_ms"] = synced_ms(b6_round(shards), devs)
        res[f"b7_round_{where}_ms"] = synced_ms(b7_round(shards, "send"), devs)
        res[f"b7_serial_{where}_ms"] = synced_ms(b7_round(shards, "serial"), devs)
    log(f"time [{card}]: a segment_copy round ({P} launches of {n_local} keys): {P} cards "
        f"{res['b6_round_cards_ms']:.3f} ms, one card {res['b6_round_one_card_ms']:.3f} ms; "
        f"a group_sort_send round, overlapped / serial: {P} cards "
        f"{res['b7_round_cards_ms']:.3f} / {res['b7_serial_cards_ms']:.3f} ms, one card "
        f"{res['b7_round_one_card_ms']:.3f} / {res['b7_serial_one_card_ms']:.3f} ms")
    del shards_cards, shards_one, part

    # -- the hash aggregate count of 256Mi Zipf(1.2) keys across the cards ------
    keys_np, uniq, counts = agg_inputs.result()
    n_agg = keys_np.size
    keys = torch.from_numpy(keys_np).to(devs[0])
    n_agg_local = n_agg // P
    expect = {**none, **full_sort_launches(n_agg_local, P),
              "binning": P * 2 * (32 // bn.PASS_WIDTH)}
    for where, m in (("cards", mesh), ("one_card", one_card)):
        fn, _ = pp.build_hash_aggregate(m, n_agg_local, op="count")
        args = (shard(keys, m), shard(torch.ones(n_agg, dtype=torch.float32, device=devs[0]), m),
                shard(torch.ones(n_agg, dtype=torch.bool, device=devs[0]), m))
        if where == "cards":
            for mod in counters.values():
                mod.launches = 0
            gk, ga, ng, overflow = fn(*args)
            sync()
            got = {name: mod.launches for name, mod in counters.items()}
            launches["hash aggregate count"] = got
            if got != expect:
                fail(f"hash aggregate across cards launches {got}, expected {expect}")
            if int(overflow):
                fail(f"hash aggregate across cards: overflow {int(overflow)}")
            sizes = [int(g) for g in ng]
            check_groups(f"hash aggregate count across {P} cards",
                         [k[:c].cpu().numpy() for k, c in zip(gk, sizes)],
                         [a[:c].cpu().numpy() for a, c in zip(ga, sizes)], uniq, counts)
            del gk, ga, ng
            res["hash_aggregate_host_syncs"] = len(host_syncs(lambda: fn(*args)))
        res[f"hash_aggregate_{where}_ms"] = synced_ms(lambda: fn(*args), devs)
        del fn, args
    log(f"time [{card}]: hash aggregate count of {n_agg} Zipf(1.2) keys, {P} ranks, exact "
        f"against np.unique, overflow 0, launches {launches['hash aggregate count']}: {P} "
        f"cards {res['hash_aggregate_cards_ms']:.3f} ms; one card "
        f"{res['hash_aggregate_one_card_ms']:.3f} ms (host clock through a synchronise of "
        f"every card, median of 10); {res['hash_aggregate_host_syncs']} host "
        f"synchronisations in a call")
    res["n_aggregate"] = n_agg
    return res


def storage_main() -> int:
    """``--storage``: the kernels' build and the storage path alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from gpu_radix_sort_tpu_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    build.load()
    res = storage_path(torch.device("cuda", 0), card)
    print(json.dumps({"storage": res}))
    log(f"chip_smoke --storage: {time.perf_counter() - t_start:.1f} s in all")
    return 0


def sample_main() -> int:
    """``--sample``: the kernels' build and the sample path alone, on the
    partial path's 256Mi PCG32 keys (its oracles made here)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from gpu_radix_sort_tpu_torch.kernels import build
    from gpu_radix_sort_tpu_torch.utils import keygen

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    zipf_pool, zipf_keys = start_zipf_keys(N_PART)
    build.load()
    dev = torch.device("cuda", 0)
    part_np = keygen.Pcg32().fill(N_PART)
    part = torch.from_numpy(part_np).to(dev)
    want = np.sort(part_np)
    zipf_np = zipf_keys.result()
    zipf_pool.shutdown()
    keep = {"zipf": (zipf_np, np.sort(zipf_np))}
    log(f"sample path: inputs and oracles made in {time.perf_counter() - t_start:.1f} s")
    res = sample_path(dev, card, part, part_np, want, keep)
    print(json.dumps({"sample": res}))
    log(f"chip_smoke --sample: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def aggregate_main() -> int:
    """``--aggregate``: the kernels' build and the hash-aggregate path alone
    (its inputs and oracles made beside the build)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from gpu_radix_sort_tpu_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    pool = side_pool()
    inputs = pool.submit(aggregate_inputs, N_AGG)
    build.load()
    res = aggregate_path(torch.device("cuda", 0), card, inputs)
    pool.shutdown()
    print(json.dumps({"aggregate": res}))
    log(f"chip_smoke --aggregate: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def bench_main() -> int:
    """``--bench``: the kernels' build and the harness step (14.) alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from gpu_radix_sort_tpu_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    build.load()
    res = bench_path(torch.device("cuda", 0), card)
    del res["records"]
    print(json.dumps({"bench": res}))
    log(f"chip_smoke --bench: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def out_of_core_main() -> int:
    """``--out-of-core``: the kernels' build and the runner's two published
    configurations, unchanged (1Gi keys; 256Mi rows with 64-byte payloads;
    width 8, one worker), each after a check of the mount's free disk and
    the host's available memory, its mount removed after."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from gpu_radix_sort_tpu_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    build.load()
    mount = os.path.join(os.path.dirname(os.path.abspath(__file__)), OOC_DIR)
    shutil.rmtree(mount, ignore_errors=True)
    os.makedirs(mount)
    res = {}
    try:
        for rows, pb in OOC_PUBLISHED:
            room = ooc_room(mount, rows, pb)
            res[ooc_name(rows, pb)] = {
                **ooc_run(card, mount, rows, pb, nworker=1), **room}
    finally:
        shutil.rmtree(mount, ignore_errors=True)
    print(json.dumps({"out_of_core": res}))
    log(f"chip_smoke --out-of-core: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def multihost_main() -> int:
    """``--multihost``: the kernels' build and the multi-process phases
    alone, their oracles made beside the build."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from gpu_radix_sort_tpu_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), MULTIHOST_DIR)
    pool = side_pool(2)
    sorted_keys = pool.submit(write_sorted_keys, N_MULTIHOST,
                              os.path.join(root, f"sorted_{N_MULTIHOST}.npy"))
    agg = pool.submit(aggregate_inputs, N_AGG)
    build.load()
    files = {N_MULTIHOST: sorted_keys.result(), **multihost_files(root, agg=agg.result())}
    pool.shutdown()
    log(f"multihost: oracles ready in {time.perf_counter() - t_start:.1f} s")
    res = multihost_path(card, files)
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"multihost": res}))
    log(f"chip_smoke --multihost: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-child"]:
        sys.exit(multihost_child(json.loads(sys.argv[2])))
    mains = {("--all-cards",): all_cards_main, ("--storage",): storage_main,
             ("--sample",): sample_main, ("--aggregate",): aggregate_main,
             ("--bench",): bench_main, ("--multihost",): multihost_main,
             ("--out-of-core",): out_of_core_main, ("--onesweep",): onesweep_main}
    sys.exit(mains.get(tuple(sys.argv[1:]), main)())
