"""Storage-mediated bulk-synchronous distributed radix sort.

Port of ``gpu_radix_sort_tpu/parallel/storage_sort.py`` (the reference's
Go orchestration layer, benchmark/pkg/sort/distrib.go): ``32/width`` rounds;
each round merges the previous round's per-digit buckets across workers
(STRIDED BucketReader), splits the stream into byte-balanced PartRef shards,
and hands each shard to a pluggable :data:`DistribWorker` that partial-sorts
it and writes one output partition per digit bucket.

Data moves through DistribArrays (memory / file / device backends) and the
workers are pluggable, out-of-process ones included
(parallel/serverless.py); with ``checkpoint_dir`` each round is persisted
and :func:`resume_sort_distrib` continues a crashed sort.

The worker sorts with the port's stable :func:`ops.radix_sort.
sort_partial_counts`: at these shard sizes binning passes (kernel B5), or
the one-block digit sort (B4) for shards of <= 2^14 keys.  On the device
backend with the stock worker the rounds run as the fused device loops
(:func:`_sort_rounds_device_fused`, :func:`_sort_rounds_device_fused64`),
keys-only sorts of rotated words through :func:`ops.radix_sort.sort_full`
(B1 and B2, or B3 at <= 2^14 keys) and int64 ``torch.sort`` for 64 bits.

Where the port differs from the JAX package:
  * No power-of-two padding.  The JAX workers pad each shard with
    0xFFFFFFFF keys to keep XLA's compile cache warm; the port's kernels
    take any n, so padding would only cost work.  Pads sort to the tail of
    the last bucket and were cut off there, so the bytes and counts are the
    same.
  * No jit caches: the fused loops are plain functions on tensors.
  * The fused loops end without a final sort: the STRIDED concatenation of
    the last round's packed partitions is already the sorted stream (each
    worker's rows hold, bucket by bucket, keys no greater than the next
    worker's), so :func:`_linearize_device` concatenates and copies once.
  * Devices: the local workers sort on the CUDA device unless ``device``
    names another, and on the data's own device when every input lies in
    device arrays.  Nothing falls back to the CPU.
  * The checkpoint manifest also records ``key_bits``, and
    :func:`resume_sort_distrib` refuses a worker of other key bits before
    any round runs (a manifest without the field, as the JAX package
    writes it, is read as ``total_bits``).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Protocol, Sequence

import numpy as np
import torch

from ..data.device import resolve_device
from ..data.helpers import fetch_part_refs, fetch_part_refs_u32
from ..data.interface import ArrayFactory, DistribArray, PartRef, create_shape
from ..ops.bits import (
    INT64_MIN, KEY_DTYPE, decode_ordered_np64, encode_ordered_np64, rotr32, rotr64,
    sortable_digits,
)
from ..ops.radix_sort import sort_full, sort_partial_counts
from ..utils.timers import SortStats
from .bucket_reader import BucketReader, ReadOrder

KEY_BYTES = 4
TOTAL_BITS = 32


def _worker_vlog(out_name: str, msg: str) -> None:
    """Worker progress breadcrumbs under GRS_VERBOSE=1."""
    if os.environ.get("GRS_VERBOSE"):
        print(f"[worker {out_name}] {msg}", file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    """End a phase's device work before its host-clock timer closes."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DistribWorker(Protocol):
    """One round's unit of work (reference: the DistribWorker plugin type,
    distrib.go:23): gather ``in_refs``, stable-sort by bits
    [offset, offset+width), create an array named ``out_name`` with 2^width
    partitions (partition d = bucket d's bytes), commit and return it."""

    def __call__(
        self,
        in_refs: Sequence[PartRef],
        offset: int,
        width: int,
        out_name: str,
        factory: ArrayFactory,
    ) -> DistribArray: ...


def _device_refs(in_refs: Sequence[PartRef]) -> bool:
    return all(getattr(r.arr, "device_native", False) for r in in_refs)


def _write_buckets(
    out_name: str, factory: ArrayFactory, rows: np.ndarray, counts: np.ndarray,
    row_bytes: int,
) -> DistribArray:
    """Commit host rows (in bucket order) as one partition a bucket."""
    caps = counts * row_bytes
    out = factory.create(out_name, create_shape(caps.tolist()))
    offsets = np.concatenate([[0], np.cumsum(counts)])
    view = memoryview(np.ascontiguousarray(rows).reshape(-1).view(np.uint8))
    for d in range(counts.size):
        lo, hi = int(offsets[d]) * row_bytes, int(offsets[d + 1]) * row_bytes
        if hi > lo:
            out.write_part(d, view[lo:hi])
    out.close()
    return out


def _empty_output(out_name: str, factory: ArrayFactory, width: int) -> DistribArray:
    out = factory.create(out_name, create_shape([0] * (1 << width)))
    out.close()
    return out


def _local_distrib_worker_device(
    in_refs: Sequence[PartRef],
    offset: int,
    width: int,
    out_name: str,
    factory: ArrayFactory,
    *,
    strategy: str | None = None,
) -> DistribArray:
    """A round with no host copy: gather on the device (views of the
    committed backings, concatenated into a new tensor), the stable partial
    sort, and a packed commit of the sorted keys; only the 2^width counts
    cross to the host."""
    segs = [
        r.arr.device_range(r.part_idx, r.start, r.nbyte)
        for r in in_refs
        if r.nbyte > 0
    ]
    segs = [s for s in segs if s.numel()]
    if not segs:
        return _empty_output(out_name, factory, width)
    # one segment stays a view of committed data: the sort reads it only
    raw = segs[0] if len(segs) == 1 else torch.cat(segs)
    if raw.numel() % KEY_BYTES:
        raise ValueError(f"gathered {raw.numel()} bytes, not 4-aligned")
    sorted_keys, counts = sort_partial_counts(
        raw.view(KEY_DTYPE), offset, width, strategy=strategy
    )
    caps = (counts.cpu().numpy().astype(np.int64) * KEY_BYTES).tolist()
    out = factory.create(out_name, create_shape(caps))
    out.put_device_packed(sorted_keys.view(torch.uint8), caps)
    out.close()
    return out


def local_distrib_worker(
    in_refs: Sequence[PartRef],
    offset: int,
    width: int,
    out_name: str,
    factory: ArrayFactory,
    *,
    strategy: str | None = None,
    device=None,
) -> DistribArray:
    """In-process worker (reference: LocalDistribWorker, distrib.go:25-84):
    fetch, stable partial sort on the device, bucket-partitioned output.
    When the factory and every input array are device-native the round
    stays on their device (:func:`_local_distrib_worker_device`); otherwise
    the keys go from the host to ``device`` (the CUDA device unless named)
    and back."""
    if getattr(factory, "device_native", False) and _device_refs(in_refs):
        return _local_distrib_worker_device(
            in_refs, offset, width, out_name, factory, strategy=strategy
        )
    dev = resolve_device(device)
    keys = fetch_part_refs_u32(in_refs)
    n = keys.size
    if n == 0:
        return _empty_output(out_name, factory, width)
    _worker_vlog(out_name, f"fetched n={n:,}; sort on {dev}")
    sorted_keys, counts = sort_partial_counts(
        torch.from_numpy(keys).to(dev), offset, width, strategy=strategy
    )
    counts = counts.cpu().numpy().astype(np.int64)
    host_sorted = sorted_keys.cpu().numpy()
    _worker_vlog(out_name, "sorted keys on host; writing buckets")
    return _write_buckets(out_name, factory, host_sorted, counts, KEY_BYTES)


# ---------------------------------------------------------------------------
# The fused device loops
# ---------------------------------------------------------------------------

def _bounds(total: int, nworker: int, row_bytes: int) -> tuple[list[int], tuple]:
    """Row bounds of the byte-balanced split (the same cuts as
    :func:`_split_refs`) and the rows of each worker."""
    n = total // row_bytes
    per_b = math.ceil(total / max(nworker, 1))
    per_b += (-per_b) % row_bytes
    per = per_b // row_bytes
    bounds = [min(w * per, n) for w in range(nworker + 1)]
    return bounds, tuple(bounds[w + 1] - bounds[w] for w in range(nworker))


def _strided_stream(arrs: Sequence[DistribArray]) -> torch.Tensor | None:
    """The uint8 device stream of the arrays' partitions in STRIDED order
    (partition 0 of every array, then partition 1, ...): one view when a
    single partition holds data, else a new tensor; None when empty."""
    shapes = [a.get_shape() for a in arrs]
    npart = max(s.npart for s in shapes)
    segs = []
    for d in range(npart):
        for a, s in zip(arrs, shapes):
            if d < s.npart and s.lens[d]:
                segs.append(a.device_range(d))
    if not segs:
        return None
    return segs[0] if len(segs) == 1 else torch.cat(segs)


def _top_digit_counts(d: torch.Tensor, width: int) -> torch.Tensor:
    """Counts (int64[2^width]) of nondecreasing digits ``d``."""
    q = torch.arange(1, 1 << width, dtype=d.dtype, device=d.device)
    starts = torch.searchsorted(d, q)
    return torch.diff(starts, prepend=starts.new_zeros(1),
                      append=starts.new_full((1,), d.numel()))


def _row_sorts32(stream: torch.Tensor, width: int, k_ws: tuple, rot: int):
    """The workers' round on the device: each worker's slice of the uint32
    ``stream`` sorted keys-only by its rotation ``rotr(x, rot)``, whose top
    ``width`` bits are the round's digit.  Returns (the sorted rows
    un-rotated and concatenated, uint32; counts (W, 2^width) int64)."""
    rows, counts = [], []
    for row in torch.split(stream.view(torch.int32), list(k_ws)):
        z = sort_full(rotr32(row.view(KEY_DTYPE), rot)) if row.numel() else row.view(KEY_DTYPE)
        counts.append(_top_digit_counts(sortable_digits(z, 32 - width, width), width))
        rows.append(rotr32(z, (32 - rot) % 32).view(torch.int32))
    return torch.cat(rows).view(KEY_DTYPE), torch.stack(counts)


def _fused_round(
    prev: torch.Tensor, offset: int, width: int, k_ws: tuple, rebuild: bool
):
    """One whole round on the device (the JAX package's
    ``_fused_round_jit``): every sort is a keys-only sort of a rotated
    word.  Round k's order (digit_k, bits [0, k*w), high bits) is the plain
    ascending order of z = rotr(x, (k+1)*w), so

      rebuild  one sort of rotr(prev, offset) is the STRIDED merge of the
               previous round's buckets (``prev`` is their packed rows);
      sort     the workers' row sorts of rotr(row, offset+width);
      counts   searches of the digit boundaries (the top bits of z).

    Worker shards are contiguous slices of the strided stream, which is
    nondecreasing in bits [0, k*w) by induction, so the byte-balanced cuts
    land where the per-worker loop puts them.  Within a bucket, keys equal
    in (digit, low bits) but different in high bits come in value order
    instead of arrival order: each bucket is the same multiset, so counts,
    partition lengths and every later round are unchanged."""
    stream = prev
    if rebuild:
        stream = rotr32(sort_full(rotr32(prev, offset)), 32 - offset)
    return _row_sorts32(stream, width, k_ws, (offset + width) % 32)


def _fused_allrounds(
    keys: torch.Tensor, width: int, k_ws: tuple, start_step: int, nstep: int
):
    """Every round on the device (the JAX package's
    ``_fused_allrounds_jit``), used when nothing observes the rounds
    between (no checkpoints).  Round k's workers' digit sorts and round
    k+1's strided merge are both one global keys-only sort of
    z = rotr(x, (k+1)w): its sorted stream is the strided merge of the
    digit-sorted buckets, and each slice of it is digit-sorted already.
    Rounds compose in z-space (rotr by w), so the loop is nstep-1 global
    sorts; only the last round's shard structure is observed, so it alone
    splits at the byte-balanced bounds and sorts each row by value."""
    zs = rotr32(keys, ((start_step + 1) * width) % 32)
    for _ in range(start_step, nstep - 1):
        zs = rotr32(sort_full(zs), width)  # z_k -> z_{k+1} space
    stream = rotr32(zs, (32 - (nstep * width) % 32) % 32)
    return _row_sorts32(stream, width, k_ws, 0)


def _commit_packed(
    factory: ArrayFactory, prefix: str, packed: torch.Tensor, counts: np.ndarray,
    bounds: list[int], row_bytes: int,
) -> list[DistribArray]:
    """One array a worker, each partition a view of the packed rows."""
    backing = packed.view(torch.uint8)
    outputs = []
    for w in range(counts.shape[0]):
        caps = (counts[w] * row_bytes).tolist()
        out = factory.create(f"{prefix}.w{w}", create_shape(caps))
        out.put_device_packed(
            backing[bounds[w] * row_bytes : bounds[w + 1] * row_bytes], caps
        )
        out.close()
        outputs.append(out)
    return outputs


def _fused_device_eligible(factory, worker, arrs, row_bytes: int) -> bool:
    """The fused device round loop keeps the per-worker loop's contract
    (names, partition contents as multisets, counts, checkpoint manifests)
    but bypasses the worker callable, so it engages only for the stock
    local worker with no pinned strategy."""
    return (
        row_bytes == KEY_BYTES
        and getattr(worker, "_fused_device_strategy", "off") is None
        and getattr(factory, "device_native", False)
        and bool(arrs)
        and all(getattr(a, "device_native", False) for a in arrs)
        and sum(sum(a.get_shape().lens) for a in arrs) > 0
    )


def _sort_rounds_device_fused(
    inputs: Sequence[DistribArray],
    name: str,
    factory: ArrayFactory,
    *,
    width: int,
    nworker: int,
    start_step: int,
    stats: SortStats,
    checkpoint_dir: str | None,
) -> list[DistribArray]:
    """The device-resident round loop: one device round and one counts
    readback a round, or, without checkpoints, every round at once.  The
    packed rows are carried between rounds; the committed DistribArrays are
    views of them, serving checkpoint manifests, the BucketReader and the
    reference's output contract (distrib.go:90-176)."""
    nstep = TOTAL_BITS // width
    arrs = list(inputs)
    total = sum(sum(a.get_shape().lens) for a in arrs)
    if total % KEY_BYTES:
        raise ValueError(f"stream of {total} bytes is not 4-aligned")
    bounds, k_ws = _bounds(total, nworker, KEY_BYTES)
    dev = arrs[0].device
    verbose = bool(os.environ.get("GRS_VERBOSE"))

    def _vlog(msg: str) -> None:
        if verbose:
            print(f"[sort_distrib {name}] (fused) {msg}", file=sys.stderr, flush=True)

    with stats.time("split"):
        packed = _strided_stream(arrs).view(KEY_DTYPE)
        _sync(dev)

    if checkpoint_dir is None:
        with stats.time("round_sort"):
            packed, counts_dev = _fused_allrounds(packed, width, k_ws, start_step, nstep)
            _sync(dev)
        with stats.time("counts_d2h"):
            counts = counts_dev.cpu().numpy()
        with stats.time("commit"):
            outputs = _commit_packed(factory, f"{name}.s{nstep - 1}", packed, counts,
                                     bounds, KEY_BYTES)
        with stats.time("destroy"):
            for a in arrs:
                a.destroy()
        stats.add("rounds", nstep - start_step)
        _vlog(f"all {nstep - start_step} rounds at once")
        return outputs

    for step in range(start_step, nstep):
        offset = step * width
        t_round = time.monotonic()
        with stats.time("round_sort"):
            packed, counts_dev = _fused_round(packed, offset, width, k_ws, step > start_step)
            _sync(dev)
        with stats.time("counts_d2h"):
            counts = counts_dev.cpu().numpy()
        with stats.time("commit"):
            outputs = _commit_packed(factory, f"{name}.s{step}", packed, counts, bounds,
                                     KEY_BYTES)
        _vlog(f"round {step + 1}/{nstep} done in {time.monotonic() - t_round:.1f}s")
        with stats.time("checkpoint"):
            _write_checkpoint(checkpoint_dir, name, step, width, outputs)
        with stats.time("destroy"):
            for a in arrs:
                a.destroy()
        arrs = outputs
        stats.add("rounds", 1)
    return arrs


def _sort_u64(z: torch.Tensor) -> torch.Tensor:
    """Ascending sort of int64 words as unsigned 64-bit patterns."""
    return torch.sort(z ^ INT64_MIN).values ^ INT64_MIN


def _fused_allrounds64(
    words: torch.Tensor, width: int, k_ws: tuple, start_step: int, nstep: int
):
    """Every 64-bit round on the device (the JAX package's
    ``_fused_allrounds64_jit``), the words being the encoded keys' bit
    patterns as int64: round k's order is the ascending unsigned order of
    z = rotr64(word, (k+1)w); rounds compose as rotr64 by w; the last round
    splits at the byte-balanced bounds and sorts each row by value, with
    the digit counts read off the top ``width`` bits.  Returns (packed rows
    int64, counts (W, 2^width) int64)."""
    zs = rotr64(words, ((start_step + 1) * width) % 64)
    for _ in range(start_step, nstep - 1):
        zs = rotr64(_sort_u64(zs), width)  # z_k -> z_{k+1} space
    stream = rotr64(zs, (64 - (nstep * width) % 64) % 64)
    rows, counts = [], []
    for row in torch.split(stream, list(k_ws)):
        z = _sort_u64(row)
        # arithmetic shift: the sign bits it brings in lie above the mask
        counts.append(_top_digit_counts((z >> (64 - width)) & ((1 << width) - 1), width))
        rows.append(z)
    return torch.cat(rows), torch.stack(counts)


def _fused_device_eligible64(factory, worker, arrs, row_bytes: int) -> bool:
    """The 64-bit fused device loop serves the stock 64-bit keys-only
    worker over device-native arrays (the same contract-keeping bypass as
    :func:`_fused_device_eligible`)."""
    return (
        row_bytes == 8
        and getattr(worker, "_fused64_ok", False)
        and getattr(factory, "device_native", False)
        and bool(arrs)
        and all(getattr(a, "device_native", False) for a in arrs)
        and sum(sum(a.get_shape().lens) for a in arrs) > 0
    )


def _sort_rounds_device_fused64(
    inputs: Sequence[DistribArray],
    name: str,
    factory: ArrayFactory,
    *,
    width: int,
    nworker: int,
    start_step: int,
    stats: SortStats,
) -> list[DistribArray]:
    """The device-resident 64-bit round loop, every round at once (used
    when nothing observes the rounds between: no checkpoints)."""
    nstep = 64 // width
    arrs = list(inputs)
    total = sum(sum(a.get_shape().lens) for a in arrs)
    if total % 8:
        raise ValueError(f"stream of {total} bytes is not 8-aligned")
    bounds, k_ws = _bounds(total, nworker, 8)
    dev = arrs[0].device
    with stats.time("split"):
        words = _strided_stream(arrs).view(torch.int64)  # little-endian rows
        _sync(dev)
    with stats.time("round_sort"):
        packed, counts_dev = _fused_allrounds64(words, width, k_ws, start_step, nstep)
        _sync(dev)
    with stats.time("counts_d2h"):
        counts = counts_dev.cpu().numpy()
    with stats.time("commit"):
        outputs = _commit_packed(factory, f"{name}.s{nstep - 1}", packed, counts, bounds, 8)
    with stats.time("destroy"):
        for a in arrs:
            a.destroy()
    stats.add("rounds", nstep - start_step)
    return outputs


# ---------------------------------------------------------------------------
# The round loop, checkpoints and resume
# ---------------------------------------------------------------------------

def _split_refs(
    arrs: Sequence[DistribArray], nworker: int, row_bytes: int = KEY_BYTES
) -> list[list[PartRef]]:
    """Byte-balanced shard split of the STRIDED bucket merge (reference:
    distrib.go:113-140), rounded to whole rows (uint32 keys, or fixed-width
    key+payload rows for the kv plane)."""
    reader = BucketReader(arrs, ReadOrder.STRIDED)
    total = reader.total_bytes
    per_worker = math.ceil(total / max(nworker, 1))
    per_worker += (-per_worker) % row_bytes
    return [reader.read_ref(per_worker) for _ in range(nworker)]


def _checkpoint_path(checkpoint_dir: str, name: str) -> str:
    return os.path.join(checkpoint_dir, f"{name}.ckpt.json")


def _write_checkpoint(
    checkpoint_dir: str, name: str, step: int, width: int, arrs,
    row_bytes: int = KEY_BYTES, total_bits: int = TOTAL_BITS,
    key_bits: int | None = None,
) -> None:
    os.makedirs(checkpoint_dir, exist_ok=True)
    payload = json.dumps(
        {
            "name": name,
            "completed_step": step,
            "width": width,
            "nworker": len(arrs),
            "row_bytes": row_bytes,
            "total_bits": total_bits,
            "key_bits": total_bits if key_bits is None else key_bits,
            "arrays": [a.name for a in arrs],
        }
    )
    path = _checkpoint_path(checkpoint_dir, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(payload)
    os.replace(tmp, path)


def load_checkpoint(checkpoint_dir: str, name: str) -> dict | None:
    """The last committed round's manifest, or None if never checkpointed."""
    path = _checkpoint_path(checkpoint_dir, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _check_key_bits(worker, key_bits: int, what: str) -> None:
    """Refuse a worker that declares other key bits than the sort's."""
    have = getattr(worker, "key_bits", None)
    if have is not None and int(have) != key_bits:
        raise ValueError(
            f"{what} has {key_bits}-bit keys but the worker sorts {have}-bit keys"
        )


def sort_distrib_from_arr(
    inputs: Sequence[DistribArray],
    name: str,
    factory: ArrayFactory,
    worker: DistribWorker,
    *,
    width: int = 8,
    nworker: int = 2,
    start_step: int = 0,
    stats: SortStats | None = None,
    checkpoint_dir: str | None = None,
    row_bytes: int = KEY_BYTES,
    total_bits: int = TOTAL_BITS,
) -> list[DistribArray]:
    """The bulk-synchronous round loop (reference: SortDistribFromArr,
    distrib.go:90-176).  Consumes (destroys) ``inputs``; returns the final
    round's output arrays -- ``nworker`` arrays of 2^width partitions whose
    STRIDED traversal is the fully sorted key stream.

    ``checkpoint_dir`` enables per-round persistence: after each round a
    manifest records the round's output array names; with a durable (file)
    factory, :func:`resume_sort_distrib` continues after a crash from the
    last committed round.

    ``total_bits=64`` runs ``64/width`` rounds over 8-byte keys (workers
    built with ``key_bits=64``; width must also divide 32 so that digit
    windows never straddle the key's word boundary).  A worker that declares
    ``key_bits`` other than ``total_bits`` is refused before any round.
    """
    if total_bits not in (32, 64):
        raise ValueError(f"total_bits must be 32 or 64, got {total_bits}")
    if width <= 0 or total_bits % width or 32 % width:
        raise ValueError(f"width {width} must divide 32 and {total_bits}")
    if total_bits == 64 and row_bytes < 8:
        raise ValueError(
            f"total_bits=64 needs >= 8-byte rows, got row_bytes={row_bytes}"
        )
    if nworker < 1:
        raise ValueError(f"nworker must be >= 1, got {nworker}")
    _check_key_bits(worker, total_bits, f"sort {name!r}")
    stats = stats if stats is not None else SortStats()
    if total_bits == TOTAL_BITS and _fused_device_eligible(
        factory, worker, list(inputs), row_bytes
    ):
        return _sort_rounds_device_fused(
            inputs, name, factory, width=width, nworker=nworker,
            start_step=start_step, stats=stats, checkpoint_dir=checkpoint_dir,
        )
    if (
        total_bits == 64
        and checkpoint_dir is None  # nothing observes intermediate rounds
        and _fused_device_eligible64(factory, worker, list(inputs), row_bytes)
    ):
        return _sort_rounds_device_fused64(
            inputs, name, factory, width=width, nworker=nworker,
            start_step=start_step, stats=stats,
        )
    nstep = total_bits // width
    arrs: list[DistribArray] = list(inputs)
    key_bits = getattr(worker, "key_bits", total_bits)
    verbose = bool(os.environ.get("GRS_VERBOSE"))

    def _vlog(msg: str) -> None:
        if verbose:
            print(f"[sort_distrib {name}] {msg}", file=sys.stderr, flush=True)

    for step in range(start_step, nstep):
        offset = step * width
        t_round = time.monotonic()
        with stats.time("split"):
            shards = _split_refs(arrs, nworker, row_bytes)
        _vlog(f"round {step + 1}/{nstep} offset={offset}: "
              f"{[sum(r.nbyte for r in s) for s in shards]} bytes/shard")
        with stats.time("workers"):
            with ThreadPoolExecutor(max_workers=nworker) as pool:
                futures = [
                    pool.submit(
                        worker, refs, offset, width, f"{name}.s{step}.w{i}", factory
                    )
                    for i, refs in enumerate(shards)
                ]
                outputs = [f.result() for f in futures]
        _vlog(f"round {step + 1}/{nstep} done in {time.monotonic() - t_round:.1f}s")
        if checkpoint_dir is not None:
            with stats.time("checkpoint"):
                _write_checkpoint(
                    checkpoint_dir, name, step, width, outputs, row_bytes,
                    total_bits, key_bits,
                )
        with stats.time("destroy"):
            for a in arrs:
                a.destroy()
        arrs = outputs
        stats.add("rounds", 1)
    return arrs


def resume_sort_distrib(
    name: str,
    factory: ArrayFactory,
    worker: DistribWorker,
    checkpoint_dir: str,
    *,
    nworker: int = 2,
    stats: SortStats | None = None,
) -> list[DistribArray]:
    """Continue a checkpointed sort from its last committed round.  A
    worker whose ``key_bits`` differ from the manifest's is refused before
    anything is opened, swept or sorted."""
    ckpt = load_checkpoint(checkpoint_dir, name)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint for {name!r} under {checkpoint_dir}")
    total_bits = int(ckpt.get("total_bits", TOTAL_BITS))
    _check_key_bits(worker, int(ckpt.get("key_bits", total_bits)),
                    f"checkpoint {name!r}")
    arrs = [factory.open(n) for n in ckpt["arrays"]]
    # Clear partial outputs of the crashed round (the round after the last
    # committed one may have created some worker arrays before dying), up to
    # the larger of the crashed run's and this run's worker counts.
    nstep = total_bits // ckpt["width"]
    sweep = max(int(ckpt.get("nworker", nworker)), nworker)
    for s in range(ckpt["completed_step"] + 1, nstep):
        for i in range(sweep):
            factory.destroy_named(f"{name}.s{s}.w{i}")
    return sort_distrib_from_arr(
        arrs, name, factory, worker,
        width=ckpt["width"],
        nworker=nworker,
        start_step=ckpt["completed_step"] + 1,
        stats=stats,
        checkpoint_dir=checkpoint_dir,
        row_bytes=int(ckpt.get("row_bytes", KEY_BYTES)),
        total_bits=total_bits,
    )


# ---------------------------------------------------------------------------
# Host-facing entry points
# ---------------------------------------------------------------------------

def _host_array(x, dtype) -> np.ndarray:
    """A numpy array of ``x`` (a numpy array, a list or a tensor) in
    ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype=dtype)


def _stage_input(
    factory: ArrayFactory, name: str, data, stats: SortStats
) -> DistribArray:
    """A one-partition input array holding ``data`` (uint32 keys or uint8
    rows, numpy or a tensor).  A device factory takes one copy to its
    device; the others the host bytes."""
    with stats.time("stage_input"):
        if getattr(factory, "device_native", False):
            t = data if isinstance(data, torch.Tensor) else torch.from_numpy(data)
            # a new tensor, as an empty input's view may have stride 0
            t = torch.empty(t.numel(), dtype=t.dtype, device=factory.device).copy_(
                t.reshape(-1))
            raw = t.view(torch.int32) if t.dtype == KEY_DTYPE else t
            raw = raw.view(torch.uint8)
            arr = factory.create(f"{name}.input", create_shape([raw.numel()]))
            arr.put_device_part(0, raw)
            _sync(factory.device)
        else:
            host = _host_array(data, None)
            arr = factory.create(f"{name}.input", create_shape([host.nbytes]))
            arr.write_part(0, memoryview(host.reshape(-1)).cast("B"))
        arr.close()
    return arr


def _linearize_device(outputs: Sequence[DistribArray]) -> np.ndarray | None:
    """STRIDED linearization on the device (one concatenation and one copy
    to the host) when every output array is device-native, as uint8 bytes;
    None otherwise."""
    if not outputs or not all(getattr(a, "device_native", False) for a in outputs):
        return None
    stream = _strided_stream(outputs)
    if stream is None:
        return np.empty(0, np.uint8)
    return stream.cpu().numpy()


def _linearize(outputs: Sequence[DistribArray], stats: SortStats) -> np.ndarray:
    with stats.time("linearize"):
        raw = _linearize_device(outputs)
        if raw is None:
            raw = np.frombuffer(BucketReader(outputs, ReadOrder.STRIDED).read(), np.uint8)
    for a in outputs:
        a.destroy()
    return raw


def sort_distrib_from_raw(
    keys,
    name: str,
    factory: ArrayFactory,
    worker: DistribWorker = local_distrib_worker,
    *,
    width: int = 8,
    nworker: int = 2,
    stats: SortStats | None = None,
    checkpoint_dir: str | None = None,
) -> np.ndarray:
    """Host-facing wrapper (reference: SortDistribFromRaw,
    distrib.go:183-248): stage uint32 keys (numpy or a tensor) into a
    one-partition input array, run the round loop, linearize the final
    buckets in STRIDED order, destroy the outputs, return the sorted uint32
    keys as a numpy array."""
    if isinstance(keys, torch.Tensor):
        if keys.dtype != KEY_DTYPE:
            raise TypeError(f"keys must be uint32, got {keys.dtype}")
        n = keys.numel()
    else:
        keys = np.ascontiguousarray(keys, dtype=np.uint32)
        n = keys.size
    stats = stats if stats is not None else SortStats()
    arr_in = _stage_input(factory, name, keys, stats)
    outputs = sort_distrib_from_arr(
        [arr_in], name, factory, worker, width=width, nworker=nworker, stats=stats,
        checkpoint_dir=checkpoint_dir,
    )
    result = _linearize(outputs, stats).view(np.uint32)
    if result.size != n:
        raise IOError(f"linearized {result.size} keys, expected {n}")
    return result


def _digit_order_counts(keys: torch.Tensor, offset: int, width: int):
    """(stable digit-sort permutation, exact digit counts int64[2^width])
    of uint32 keys: a stable ``torch.sort`` of the narrow digits, the JAX
    package's ``lax.sort_key_val`` (an XLA sort, not a Pallas kernel)."""
    sorted_digits, order = torch.sort(sortable_digits(keys, offset, width), stable=True)
    return order, _top_digit_counts(sorted_digits, width)


def local_distrib_worker_kv(
    in_refs: Sequence[PartRef],
    offset: int,
    width: int,
    out_name: str,
    factory: ArrayFactory,
    *,
    row_bytes: int,
    key_bits: int = 32,
    device=None,
) -> DistribArray:
    """KV-row worker: rows are fixed-width [key | payload] byte records
    moving through the byte-blind plane.

    ``key_bits=32``: a 4-byte uint32 key leads each row.  ``key_bits=64``:
    an 8-byte little-endian order-encoded word leads each row
    (:func:`ops.bits.encode_ordered_np64`) and ``offset`` addresses bits of
    the 64-bit key; the digit window lies in word ``offset // 32`` because
    width divides 32, so each round moves one 4-byte lane to the device.

    Only that 4-byte digit word goes to ``device`` (the CUDA device unless
    named), for the stable digit order and the exact counts; the payload
    rows are permuted on the host, next to the storage they came from.
    """
    if key_bits not in (32, 64):
        raise ValueError(f"key_bits must be 32 or 64, got {key_bits}")
    key_bytes = key_bits // 8
    if row_bytes < key_bytes or (key_bits == 32 and row_bytes == KEY_BYTES):
        raise ValueError(f"row_bytes {row_bytes} too small for key_bits {key_bits}")
    if offset + width > key_bits or (offset % 32) + width > 32:
        raise ValueError(
            f"digit window [{offset}, {offset + width}) invalid for "
            f"key_bits {key_bits} (must lie within one 32-bit word)"
        )
    dev = resolve_device(device)
    buf = fetch_part_refs(in_refs)
    if len(buf) % row_bytes:
        raise ValueError(
            f"gathered {len(buf)} bytes, not a multiple of row_bytes {row_bytes}"
        )
    rows = np.frombuffer(buf, dtype=np.uint8).reshape(-1, row_bytes)
    n = rows.shape[0]
    if n == 0:
        return _empty_output(out_name, factory, width)
    col = KEY_BYTES * (offset // 32)
    keys = np.ascontiguousarray(rows[:, col : col + KEY_BYTES]).view(np.uint32).reshape(-1)
    _worker_vlog(out_name, f"fetched n={n:,} rows; digit order on {dev}")
    order, counts = _digit_order_counts(torch.from_numpy(keys).to(dev), offset % 32, width)
    order = order.cpu().numpy()
    counts = counts.cpu().numpy()
    _worker_vlog(out_name, "order on host; permuting rows")
    # one record a row: numpy's 2-D row indexing copies each row element by
    # element, 2-4x slower than indexing the rows as fixed-size records
    records = rows.view(np.dtype((np.void, row_bytes))).reshape(-1)
    return _write_buckets(out_name, factory, records[order].view(np.uint8), counts, row_bytes)


def _split_kv_rows(raw: np.ndarray, n: int, row_bytes: int) -> np.ndarray:
    got = raw.reshape(-1, row_bytes)
    if got.shape[0] != n:
        raise IOError(f"linearized {got.shape[0]} rows, expected {n}")
    return got


def sort_distrib_from_raw_kv(
    keys,
    payload,
    name: str,
    factory: ArrayFactory,
    worker: DistribWorker | None = None,
    *,
    width: int = 8,
    nworker: int = 2,
    stats: SortStats | None = None,
    checkpoint_dir: str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Storage-mediated distributed stable key-value sort: interleave uint32
    keys with fixed-width payload rows ((n, B) uint8), run the round loop
    through the byte-blind plane, split the linearized rows back.  Returns
    (sorted_keys, payload_in_sorted_order), a stable kv sort's."""
    keys = _host_array(keys, np.uint32)
    payload = _host_array(payload, np.uint8)
    n = keys.size
    if payload.ndim != 2 or payload.shape[0] != n:
        raise ValueError(
            f"payload must be (n, B) uint8 with n == len(keys); got "
            f"{payload.shape} for n={n}"
        )
    row_bytes = KEY_BYTES + payload.shape[1]
    stats = stats if stats is not None else SortStats()
    if worker is None:
        worker = make_kv_worker(row_bytes)
    rows = np.empty((n, row_bytes), dtype=np.uint8)
    rows[:, :KEY_BYTES] = keys.view(np.uint8).reshape(n, KEY_BYTES)
    rows[:, KEY_BYTES:] = payload
    arr_in = _stage_input(factory, name, rows.reshape(-1), stats)
    del rows
    outputs = sort_distrib_from_arr(
        [arr_in], name, factory, worker, width=width, nworker=nworker, stats=stats,
        checkpoint_dir=checkpoint_dir, row_bytes=row_bytes,
    )
    got = _split_kv_rows(_linearize(outputs, stats), n, row_bytes)
    out_keys = np.ascontiguousarray(got[:, :KEY_BYTES]).view(np.uint32).reshape(-1)
    return out_keys, np.ascontiguousarray(got[:, KEY_BYTES:])


def make_kv_worker(row_bytes: int, key_bits: int = 32, device=None) -> DistribWorker:
    """A kv-row DistribWorker with the row width, key width and device
    pinned: the round loop's worker signature stays the reference's
    5-argument contract."""

    def worker(in_refs, offset, width, out_name, factory):
        return local_distrib_worker_kv(
            in_refs, offset, width, out_name, factory, row_bytes=row_bytes,
            key_bits=key_bits, device=device,
        )

    # 8-byte keys-only 64-bit rows may take the fused 64-bit device loop
    worker._fused64_ok = key_bits == 64 and row_bytes == 8
    worker.key_bits = key_bits
    return worker


def _encode_rows_64(keys) -> tuple[np.ndarray, np.dtype, int]:
    """64-bit keys -> (n, 8) little-endian order-encoded byte rows."""
    keys = _host_array(keys, None)
    if keys.dtype not in (np.uint64, np.int64, np.float64):
        raise TypeError(
            f"64-bit storage sorts take uint64/int64/float64 keys, got {keys.dtype}"
        )
    enc = np.ascontiguousarray(encode_ordered_np64(keys), dtype="<u8")
    return enc.view(np.uint8).reshape(-1, 8), keys.dtype, keys.size


def _decode_rows_64(rows: np.ndarray, dtype) -> np.ndarray:
    enc = np.ascontiguousarray(rows).view("<u8").reshape(-1)
    return decode_ordered_np64(enc, dtype)


def sort_distrib_from_raw_u64(
    keys,
    name: str,
    factory: ArrayFactory,
    worker: DistribWorker | None = None,
    *,
    width: int = 8,
    nworker: int = 2,
    stats: SortStats | None = None,
    checkpoint_dir: str | None = None,
) -> np.ndarray:
    """Storage-mediated distributed sort of 64-bit keys (uint64 / int64 /
    float64 in totalOrder): ``64/width`` LSD rounds over 8-byte
    order-encoded rows; each round's worker moves only the 4-byte digit
    word to the device (:func:`local_distrib_worker_kv` with key_bits=64).
    On the device backend without checkpoints the rounds run as the fused
    64-bit loop."""
    rows, dtype, n = _encode_rows_64(keys)
    stats = stats if stats is not None else SortStats()
    if worker is None:
        worker = make_kv_worker(8, key_bits=64)
    arr_in = _stage_input(factory, name, rows.reshape(-1), stats)
    outputs = sort_distrib_from_arr(
        [arr_in], name, factory, worker, width=width, nworker=nworker, stats=stats,
        checkpoint_dir=checkpoint_dir, row_bytes=8, total_bits=64,
    )
    return _decode_rows_64(_split_kv_rows(_linearize(outputs, stats), n, 8), dtype)


def sort_distrib_from_raw_kv64(
    keys,
    payload,
    name: str,
    factory: ArrayFactory,
    worker: DistribWorker | None = None,
    *,
    width: int = 8,
    nworker: int = 2,
    stats: SortStats | None = None,
    checkpoint_dir: str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Storage-mediated distributed stable key-value sort with 64-bit keys:
    rows are [8-byte order-encoded key | payload]; ties keep input order.
    Returns (sorted_keys, payload_in_sorted_order)."""
    enc_rows, dtype, n = _encode_rows_64(keys)
    payload = _host_array(payload, np.uint8)
    if payload.ndim != 2 or payload.shape[0] != n:
        raise ValueError(
            f"payload must be (n, B) uint8 with n == len(keys); got "
            f"{payload.shape} for n={n}"
        )
    row_bytes = 8 + payload.shape[1]
    stats = stats if stats is not None else SortStats()
    if worker is None:
        worker = make_kv_worker(row_bytes, key_bits=64)
    rows = np.empty((n, row_bytes), dtype=np.uint8)
    rows[:, :8] = enc_rows
    rows[:, 8:] = payload
    arr_in = _stage_input(factory, name, rows.reshape(-1), stats)
    del rows
    outputs = sort_distrib_from_arr(
        [arr_in], name, factory, worker, width=width, nworker=nworker, stats=stats,
        checkpoint_dir=checkpoint_dir, row_bytes=row_bytes, total_bits=64,
    )
    got = _split_kv_rows(_linearize(outputs, stats), n, row_bytes)
    return _decode_rows_64(got[:, :8], dtype), np.ascontiguousarray(got[:, 8:])


def make_local_worker(strategy: str | None = None, device=None) -> DistribWorker:
    """A LocalDistribWorker with a pinned sort strategy and device.  Only
    the unpinned worker (``strategy=None``) may take the fused device loop:
    a pinned strategy goes through sort_partial_counts a worker a round."""

    def worker(in_refs, offset, width, out_name, factory):
        return local_distrib_worker(
            in_refs, offset, width, out_name, factory, strategy=strategy, device=device
        )

    worker._fused_device_strategy = strategy
    worker.key_bits = 32
    return worker


# Stock worker, no pinned strategy: eligible for the fused device loop.
local_distrib_worker._fused_device_strategy = None
local_distrib_worker.key_bits = 32
