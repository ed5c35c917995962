"""Out-of-core storage-plane sort runner (BASELINE configs 1 & 3).

Port of ``benchmarks/run_out_of_core.py``.  Runs the multi-round
storage-mediated distributed sort at scales that exceed device memory,
through the file backend (the reference's 512Mi-key workload,
benchmark/pkg/benchmark/benchmark.go:126-180, scaled up):

  keys-only:  python -m gpu_radix_sort_tpu_torch.benchmarks.run_out_of_core \\
                  --rows 1073741824
  config 3:   python -m gpu_radix_sort_tpu_torch.benchmarks.run_out_of_core \\
                  --rows 268435456 --payload-bytes 64

Exactness proof without holding a (rows x payload) oracle in RAM
(:func:`verify_stream`):
  * keys: the full sorted key stream is compared chunk-by-chunk against
    np.sort of the (re-generated) input keys -- exact.
  * payload binding: payload bytes are a pure function of (key, original
    row index); every output row is checked against f(key, idx).
  * stability + permutation: within an equal-key run original indices must
    STRICTLY increase -- with the exact key match and the binding this also
    proves no row was duplicated or dropped (a repeat inside a run breaks
    strict increase; a cross-key swap breaks the key stream or binding).

Prints one JSON line on stdout; diagnostics on stderr.  Exit codes: 0
exact, 1 mismatch, 2 a staged input of the wrong size (and argparse's usage
errors).

Where the port differs from the JAX runner:
  * ``--device``: the workers sort on the CUDA device unless ``cpu`` (or
    another device) is named.  Without CUDA the runner raises before it
    stages anything; it never goes on on the CPU.
  * ``--mount`` defaults to ``ooc_mount`` under the working directory.
  * One ``main()`` is split into :func:`stage_input`, :func:`run_sort`,
    :func:`verify_stream` and :func:`main`, which returns the exit code, so
    that tests and ``chip_smoke.py`` run the runner in-process.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import threading
import time

import numpy as np

from ..data import FileArrayFactory, create_shape
from ..data.device import resolve_device
from ..parallel import (
    BucketReader,
    ReadOrder,
    local_distrib_worker,
    make_kv_worker,
    sort_distrib_from_arr,
)
from ..parallel.storage_sort import KEY_BYTES
from ..utils.keygen import Pcg32
from ..utils.timers import SortStats

KEY_XOR = np.uint32(0xA5A5A5A5)
CHUNK_ROWS = 1 << 22  # 4M rows per staging/verify chunk


class StagedInputError(ValueError):
    """An input staged earlier (``--skip-staging``) that is not this run's size."""


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def payload_for(keys: np.ndarray, idx0: int, payload_bytes: int,
                out: np.ndarray | None = None) -> np.ndarray:
    """Deterministic payload rows for keys[i] at original index idx0+i:
    [key ^ KEY_XOR (4B LE)] [index (8B LE, or 4B LE when payload < 12B)]
    [filler = (index + j) & 0xFF].  The index field is what lets the
    verifier prove stability and row conservation without an oracle of
    the full payload; 8-byte payloads carry it as u32 (valid to 2^32-1
    rows)."""
    n = keys.size
    if out is None:
        out = np.empty((n, payload_bytes), dtype=np.uint8)
    out[:, :4] = (keys ^ KEY_XOR).view(np.uint8).reshape(n, 4)
    idx = np.arange(idx0, idx0 + n, dtype=np.uint64)
    # (idx + j) & 0xFF == u8 wraparound of (idx & 0xFF) + (j & 0xFF):
    # staying in uint8 avoids an (n, payload) uint64 temporary (~8x the
    # memory traffic -- it page-fault-thrashed at 17 GiB scale).
    idx8 = (idx & np.uint64(0xFF)).astype(np.uint8)
    if payload_bytes >= 12:
        out[:, 4:12] = idx.view(np.uint8).reshape(n, 8)
        j8 = np.arange(12, payload_bytes, dtype=np.uint64).astype(np.uint8)
        np.add(idx8[:, None], j8[None, :], out=out[:, 12:])
    elif payload_bytes >= 8:
        out[:, 4:8] = idx.astype(np.uint32).view(np.uint8).reshape(n, 4)
        j8 = np.arange(8, payload_bytes, dtype=np.uint64).astype(np.uint8)
        np.add(idx8[:, None], j8[None, :], out=out[:, 8:])
    else:
        raise ValueError("payload_bytes must be >= 8 (binding + index)")
    return out


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX runner's flags, defaults and argument errors, and ``--device``."""
    ap = argparse.ArgumentParser(
        prog="python -m gpu_radix_sort_tpu_torch.benchmarks.run_out_of_core")
    ap.add_argument("--rows", type=int, default=1 << 30)
    ap.add_argument("--payload-bytes", type=int, default=0)
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--nworker", type=int, default=1)
    ap.add_argument("--mount", default="ooc_mount")
    ap.add_argument("--name", default="ooc")
    ap.add_argument(
        "--parallel-workers", action="store_true",
        help="let workers run concurrently (default: serialize -- one card "
        "owns the device work and concurrent shards would double peak "
        "device memory)",
    )
    ap.add_argument(
        "--stage-only", action="store_true",
        help="write the input array and exit (host-only; lets staging run "
        "while another process owns the card)",
    )
    ap.add_argument(
        "--skip-staging", action="store_true",
        help="reuse an input array staged earlier by --stage-only "
        "(the key oracle is regenerated -- the PCG32 stream is deterministic)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="device of the workers' sorts (default: the CUDA device; cpu "
        "only when asked)",
    )
    args = ap.parse_args(argv)
    pb = args.payload_bytes
    if 8 <= pb < 12 and args.rows > (1 << 32):
        # the 8-11B payload carries the original index as u32; beyond
        # 2^32 rows it wraps and the stability/conservation proof breaks
        # (a correct sort would be reported as a FATAL stability
        # violation).  12B+ payloads carry a u64 index.
        ap.error("--payload-bytes < 12 limits --rows to 2^32 (u32 index)")
    if pb != 0 and pb < 8:
        # The streaming exactness proof needs the key-xor binding (4B) AND
        # the original-index field (>=4B): without the index, stability and
        # row conservation cannot be proven and "exact" would overclaim.
        ap.error("--payload-bytes must be 0 (keys-only) or >= 8")
    return args


def stage_input(factory, name: str, n: int, payload_bytes: int, *,
                reuse: bool = False):
    """The input array ``{name}.input``: the first ``n`` keys of the PCG32
    stream, alone or as [key | payload_for] rows, written through the part
    writer in CHUNK_ROWS-row chunks (no full-row materialization).  With
    ``reuse`` the array staged earlier is opened instead, and a size other
    than this run's raises :class:`StagedInputError`."""
    row_bytes = KEY_BYTES + payload_bytes
    if reuse:
        arr_in = factory.open(f"{name}.input")
        got = sum(arr_in.get_shape().lens)
        if got != n * row_bytes:
            raise StagedInputError(
                f"staged input holds {got} bytes, want {n * row_bytes}")
        return arr_in
    arr_in = factory.create(f"{name}.input", create_shape([n * row_bytes]))
    w = arr_in.get_part_writer(0)
    gen = Pcg32()
    for c0 in range(0, n, CHUNK_ROWS):
        c1 = min(c0 + CHUNK_ROWS, n)
        keys = gen.fill(c1 - c0)
        if payload_bytes:
            rows = np.empty((c1 - c0, row_bytes), dtype=np.uint8)
            rows[:, :4] = keys.view(np.uint8).reshape(-1, 4)
            payload_for(keys, c0, payload_bytes, out=rows[:, 4:])
            w.write(memoryview(rows.reshape(-1)))
        else:
            w.write(memoryview(keys.view(np.uint8)))
    arr_in.close()
    return arr_in


def run_sort(arr_in, factory, name: str, *, width: int, nworker: int,
             row_bytes: int, device, parallel_workers: bool = False,
             stats: SortStats | None = None) -> list:
    """Sort the staged rows through the storage rounds on ``device``;
    consumes ``arr_in`` and returns the final round's output arrays, whose
    STRIDED traversal is the sorted stream.  The workers run one at a time
    unless ``parallel_workers``: one card owns the device work, and
    concurrent shards would double peak device memory."""
    if row_bytes > KEY_BYTES:
        worker = make_kv_worker(row_bytes, device=device)
    else:
        worker = functools.partial(local_distrib_worker, device=device)
    if not parallel_workers:
        lock = threading.Lock()
        inner = worker

        def worker(refs, offset, width, out_name, fac):
            with lock:
                return inner(refs, offset, width, out_name, fac)

    return sort_distrib_from_arr(
        [arr_in], name, factory, worker, width=width, nworker=nworker,
        stats=stats, row_bytes=row_bytes,
    )


def verify_stream(outputs, n: int, payload_bytes: int) -> tuple[bool, str]:
    """The streaming exactness proof of ``outputs``, the sorted arrays of
    the ``n``-row input that :func:`stage_input` writes: (True, "") or
    (False, the first fault found, in the JAX runner's words).

    The oracle is REGENERATED here (deterministic PCG32 stream) rather
    than held through the sort: peak host RSS during the rounds drops by
    rows*4 bytes (16 GB at the 4B-row config)."""
    pb = payload_bytes
    row_bytes = KEY_BYTES + pb
    all_keys = np.empty(n, dtype=np.uint32)
    oracle_gen = Pcg32()
    for c0 in range(0, n, CHUNK_ROWS):
        c1 = min(c0 + CHUNK_ROWS, n)
        all_keys[c0:c1] = oracle_gen.fill(c1 - c0)
    want_keys = np.sort(all_keys)
    del all_keys
    reader = BucketReader(outputs, ReadOrder.STRIDED)
    pos = 0
    prev_key = prev_idx = None
    while True:
        raw = reader.read(CHUNK_ROWS * row_bytes)
        if not raw:
            break
        rows = np.frombuffer(raw, dtype=np.uint8).reshape(-1, row_bytes)
        m = rows.shape[0]
        keys = np.ascontiguousarray(rows[:, :4]).view(np.uint32).reshape(-1)
        if not np.array_equal(keys, want_keys[pos : pos + m]):
            return False, f"key mismatch in chunk at row {pos}"
        if pb:
            pay = rows[:, 4:]
            kx = np.ascontiguousarray(pay[:, :4]).view(np.uint32).reshape(-1)
            if not np.array_equal(kx, keys ^ KEY_XOR):
                return False, f"payload/key binding broken at row {pos}"
            if pb >= 12:
                idx = np.ascontiguousarray(pay[:, 4:12]).view(np.uint64).reshape(-1)
                fill0 = 12
            else:
                idx = np.ascontiguousarray(pay[:, 4:8]).view(
                    np.uint32).reshape(-1).astype(np.uint64)
                fill0 = 8
            if int(idx.max(initial=0)) >= n:
                return False, "out-of-range original index"
            if pb > fill0:
                j8 = np.arange(fill0, pb, dtype=np.uint64).astype(np.uint8)
                want_fill = (idx & np.uint64(0xFF)).astype(np.uint8)[:, None] + j8[None, :]
                if not np.array_equal(pay[:, fill0:], want_fill):
                    return False, f"payload filler mismatch at row {pos}"
            # stability: indices increase within equal-key runs (include
            # the boundary with the previous chunk)
            kk = keys if prev_key is None else np.concatenate([[prev_key], keys])
            ii = idx if prev_idx is None else np.concatenate([[prev_idx], idx])
            same = kk[1:] == kk[:-1]
            if np.any(same & ~(ii[1:] > ii[:-1])):
                return False, f"stability violated near row {pos}"
            prev_key, prev_idx = keys[-1], idx[-1]
        pos += m
    if pos != n:
        return False, f"linearized {pos} rows, expected {n}"
    return True, ""


def main(argv=None) -> int:
    """Stage, sort, prove and print the JSON line; returns the exit code."""
    try:
        args = parse_args(argv)
    except SystemExit as exc:  # argparse's usage errors (2) and --help (0)
        return exc.code
    dev = resolve_device(args.device)
    n = args.rows
    pb = args.payload_bytes
    row_bytes = KEY_BYTES + pb
    factory = FileArrayFactory(args.mount)
    stats = SortStats()
    t_start = time.perf_counter()

    log(f"rows={n:,} payload={pb}B row={row_bytes}B width={args.width} "
        f"nworker={args.nworker} total={n * row_bytes / 2**30:.1f} GiB "
        f"device={dev}")

    t0 = time.perf_counter()
    try:
        arr_in = stage_input(factory, args.name, n, pb, reuse=args.skip_staging)
    except StagedInputError as exc:
        log(f"FATAL: {exc}")
        return 2
    if args.skip_staging:
        log("reused staged input")
    else:
        log(f"staged input in {time.perf_counter() - t0:.1f}s")
        if args.stage_only:
            log("stage-only: done")
            return 0

    t0 = time.perf_counter()
    outputs = run_sort(
        arr_in, factory, args.name, width=args.width, nworker=args.nworker,
        row_bytes=row_bytes, device=dev, parallel_workers=args.parallel_workers,
        stats=stats,
    )
    sort_s = time.perf_counter() - t0
    log(f"sorted in {sort_s:.1f}s  phases={stats.report()}")

    t0 = time.perf_counter()
    ok, fault = verify_stream(outputs, n, pb)
    if not ok:
        log(f"FATAL: {fault}")
    log(f"verified in {time.perf_counter() - t0:.1f}s: "
        f"{'EXACT' if ok else 'MISMATCH'}")

    for a in outputs:
        a.destroy()

    total_s = time.perf_counter() - t_start
    print(json.dumps({
        "metric": f"out_of_core_{'kv' + str(pb) + 'B' if pb else 'keys'}"
                  f"_w{args.width}",
        "rows": n,
        "row_bytes": row_bytes,
        "sort_s": round(sort_s, 1),
        "rows_per_s": round(n / sort_s, 1),
        "exact": ok,
        "total_s": round(total_s, 1),
        "phases": stats.report(),
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
