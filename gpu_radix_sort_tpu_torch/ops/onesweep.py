"""Ascending sort of uint32 keys by four stable 8-bit LSD passes: the
wrapper of ``csrc/onesweep.cu``.

Replaces no TPU kernel.  The JAX package's ``sort_full`` is a tile sort and
merge levels, a shape the TPU forced (no scatter inside a Mosaic kernel, a
grid that runs in order on one core); on the H100 the port takes it only
below a measured size (``ops/radix_sort.py``, ``ONESWEEP_MIN_N``) and above
it sorts by digits, onesweep style (Adinets & Merrill, 2022): one launch
counts all four digits, then one launch a digit moves every key once,
finding each tile's place by a decoupled look-back over the tiles before
it.  Bytes: 4.5 reads and writes of every key (~9 GiB at 2^28 keys) against
15 for the tile pass and 14 merge levels (~30 GiB).

    histogram   x -> the four digit histograms, scanned
    pass 0..3   x -> tmp -> out -> tmp -> out, bits 8p .. 8p + 7

The passes ping-pong through one buffer beside the output; ``x`` is never
written.  The scratch, zeroed here, holds the histograms, the tile counters
and the look-back state: one word a (tile, digit), for every tile but the
last, whose status codes rotate from pass to pass, so it is zeroed once a
sort (:func:`scratch_words`: 15.5 MiB at 2^28 keys).

On a CPU tensor :func:`sort_full_onesweep` runs :func:`sort_full_onesweep_plain`,
four stable ``torch.sort`` passes of the digits; on a CUDA tensor it
launches the kernels or raises.  :func:`sort_emulated` repeats the kernels'
arithmetic in numpy for the CPU tests: each tile's warp-striped count, scan
and place, the look-back in an order drawn from a seed, the recovery of the
exact counts from counts mod 2^30, and the stores.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from .bits import sortable_digits
from .block_sort import check_keys

BITS = 8  # digit bits a pass (kBits in csrc/onesweep.cu)
BINS = 1 << BITS
PASSES = 32 // BITS
THREADS = 512  # threads of a pass block (kThreads)
KEYS = 33  # keys a thread (kKeys)
TILE = THREADS * KEYS  # keys a pass block (kTile)
HEADER_WORDS = 1056  # scratch words before the look-back state (kHeader)
VALUE_BITS = 30  # count bits of a look-back word; the top two are its status
MAX_N = 1 << 31  # the counts mod 2^30 fix the exact ones up to here
AGGREGATE = 1  # status of a tile's own counts
LAUNCHES = 1 + PASSES  # kernel launches a sort: the histogram and the passes
_WARP = 32

launches = 0  # kernel launches, for showing that a run went through the kernels


def tiles(n: int, tile: int = TILE) -> int:
    return -(-n // tile)


def scratch_words(n: int) -> int:
    """Words of scratch a sort of n keys takes: the header, and 256 words
    of look-back state for every tile but the last."""
    return HEADER_WORDS + max(tiles(n) - 1, 0) * BINS


def prefix_code(pass_: int) -> int:
    """Status of a PREFIX word in pass ``pass_``: 2, 3, 0, 2."""
    return (2, 3, 0)[pass_ % 3]


def wait_code(pass_: int) -> int:
    """Status a pass reads as "not ready": the zeroed words in pass 0, the
    last pass's PREFIX after it."""
    return 0 if pass_ == 0 else prefix_code(pass_ - 1)


def sort_full_onesweep_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: four stable sorts by the 8-bit digits, least
    significant first."""
    x = keys
    for p in range(PASSES):
        order = torch.sort(sortable_digits(x, p * BITS, BITS), stable=True).indices
        x = x.view(torch.int32)[order].view(torch.uint32)
    return x


def _place(tile_keys: np.ndarray, bit0: int, threads: int, keys: int):
    """One tile's count, scan and place as the pass kernel runs them: key i
    of the tile in warp i // (32 keys), step (i // 32) % keys, lane i % 32.
    Returns each key's slot, the tile's digit counts and each digit's first
    slot, and asserts that the slots are a stable sort by digit."""
    m, warps = tile_keys.size, threads // _WARP
    digits = (tile_keys.astype(np.int64) >> bit0) & (BINS - 1)
    cnt = np.zeros((BINS, warps), np.int64)
    np.add.at(cnt, (digits, np.arange(m) // (_WARP * keys)), 1)
    flat = cnt.reshape(-1)  # digit-major, warp-minor
    ctr = (np.cumsum(flat) - flat).reshape(BINS, warps)
    local_start = ctr[:, 0].copy()
    slot = np.full(m, -1, np.int64)
    lanes = np.arange(_WARP)
    for w in range(warps):
        for k in range(keys):
            i = w * _WARP * keys + k * _WARP + lanes
            valid = i < m
            if not valid.any():
                continue
            d = np.where(valid, digits[np.minimum(i, m - 1)], 0)  # pads load key 0
            peers = (d[:, None] == d[None, :]) & (valid[:, None] == valid[None, :])
            below = (peers & (lanes[None, :] < lanes[:, None])).sum(1)
            leader = np.argmax(peers, axis=1)  # the lowest lane of its peers
            lead = np.flatnonzero(valid & (leader == lanes))  # distinct digits
            base = np.zeros(_WARP, np.int64)
            base[lead] = ctr[d[lead], w]
            ctr[d[lead], w] += peers[lead].sum(1)
            base = base[leader]  # the shuffle from the leader
            slot[i[valid]] = base[valid] + below[valid]
    assert np.array_equal(np.sort(slot), np.arange(m)), "every slot is written once"
    assert np.array_equal(np.argsort(slot), np.argsort(digits, kind="stable")), "stable"
    return slot, cnt.sum(1), local_start


def _look_back(totals: np.ndarray, state: np.ndarray, pass_: int, value_bits: int,
               rng: np.random.Generator, resident: int) -> np.ndarray:
    """The pass's decoupled look-back in an order drawn from ``rng``: tiles
    taken in order from the counter, at most ``resident`` at once; a step
    of a tile publishes its counts (AGGREGATE, or PREFIX for tile 0) or
    reads one word back for each digit still looking (a word not ready is
    read again later), and a digit publishes its PREFIX once it meets one.
    ``state`` (tiles - 1 rows of BINS packed words) carries over from the
    last pass.  Returns each tile's exclusive counts mod 2^value_bits."""
    n_tiles = totals.shape[0]
    mask = (1 << value_bits) - 1
    prefix, waiting = prefix_code(pass_), wait_code(pass_)
    excl = np.zeros((n_tiles, BINS), np.int64)
    ptr = np.zeros((n_tiles, BINS), np.int64)  # the tile a digit reads next
    looking = np.zeros((n_tiles, BINS), bool)
    phase = np.zeros(n_tiles, np.int64)  # 0 to publish, 1 looking back, 2 done
    active: list[int] = []
    taken = 0

    def publish(t: int, digits: np.ndarray, status: int, values: np.ndarray) -> None:
        if t + 1 < n_tiles:
            state[t, digits] = (status << value_bits) | (values & mask)

    budget = 1000 + 200 * n_tiles * n_tiles  # steps: a look-back that never ends fails
    while taken < n_tiles or active:
        budget -= 1
        assert budget > 0, "the look-back made no progress"
        can_take = taken < n_tiles and len(active) < resident
        pick = int(rng.integers(len(active) + can_take))
        if pick == len(active):
            active.append(taken)
            taken += 1
            continue
        t = active[pick]
        if phase[t] == 0:
            every = np.arange(BINS)
            publish(t, every, prefix if t == 0 else AGGREGATE, totals[t])
            phase[t] = 1
            looking[t] = t > 0
            ptr[t] = t - 1
        else:
            d = np.flatnonzero(looking[t])
            words = state[ptr[t, d], d]
            status, value = words >> value_bits, words & mask
            ready = status != waiting
            excl[t, d[ready]] += value[ready]
            done = d[ready & (status == prefix)]
            looking[t, done] = False
            ptr[t, d[ready & (status != prefix)]] -= 1
            publish(t, done, prefix, excl[t, done] + totals[t, done])
        if not looking[t].any() and phase[t] == 1:
            phase[t] = 2
            active.remove(t)
    assert (state >> value_bits == prefix).all(), "every word ends as this pass's PREFIX"
    return excl & mask


def sort_emulated(
    x: torch.Tensor, *, threads: int = THREADS, keys: int = KEYS,
    value_bits: int = VALUE_BITS, seed: int = 0, resident: int = 4,
) -> torch.Tensor:
    """The kernels' arithmetic on a CPU tensor, at the given geometry: the
    histograms and their scans; then for each pass each tile's count, scan
    and place (:func:`_place`), the look-back in an order drawn from
    ``seed`` with ``resident`` tiles in flight (:func:`_look_back`) on one
    state carried over from pass to pass, each exact count recovered from
    its value mod 2^value_bits, and the stores to shift[digit] + slot.
    Asserts the recovered counts, that each output slot is written once and
    that each pass is stable."""
    xs = x.numpy().astype(np.uint32)
    n, tile = xs.size, threads * keys
    if n > 1 << (value_bits + 1):
        raise ValueError(f"counts mod 2^{value_bits} fix exact ones up to 2^{value_bits + 1} keys")
    if n == 0:
        return x.clone()
    rng = np.random.default_rng(seed)
    n_tiles = tiles(n, tile)
    mask = (1 << value_bits) - 1
    state = np.zeros((max(n_tiles - 1, 0), BINS), np.int64)
    for p in range(PASSES):
        bit0 = p * BITS
        digits = (xs.astype(np.int64) >> bit0) & (BINS - 1)
        count = np.bincount(digits, minlength=BINS)
        start = np.cumsum(count) - count
        placed = [_place(xs[t * tile:(t + 1) * tile], bit0, threads, keys)
                  for t in range(n_tiles)]
        totals = np.stack([c for _, c, _ in placed])
        excl = _look_back(totals, state, p, value_bits, rng, resident)
        exact = np.cumsum(totals, axis=0) - totals
        out = np.zeros(n, np.uint32)
        written = np.zeros(n, np.int64)
        for t, (slot, total, local_start) in enumerate(placed):
            m = slot.size
            after = n - t * tile - m
            lo = np.maximum(0, count - total - after)
            e = lo + ((excl[t] - lo) & mask)
            assert np.array_equal(e, exact[t]), "the exact counts before the tile"
            shift = start + e - local_start
            sorted_keys = xs[t * tile:t * tile + m][np.argsort(slot)]
            i = np.arange(m)
            dst = shift[(sorted_keys.astype(np.int64) >> bit0) & (BINS - 1)] + i
            out[dst] = sorted_keys
            np.add.at(written, dst, 1)
        assert (written == 1).all(), "every output slot is written once"
        assert np.array_equal(out, xs[np.argsort(digits, kind="stable")]), "a stable pass"
        xs = out
    return torch.from_numpy(xs)


def sort_full_onesweep(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of 1-D contiguous uint32 keys, n <= MAX_N, by the
    histogram and four digit passes.  Returns a new tensor; peak memory the
    input, two buffers of its size and :func:`scratch_words`."""
    global launches
    check_keys(keys)
    n = keys.numel()
    if n > MAX_N:
        raise ValueError(f"the onesweep sort takes at most {MAX_N} keys, got {n}")
    if keys.device.type == "cpu":
        return sort_full_onesweep_plain(keys)
    out = torch.empty_like(keys)
    if n == 0:
        return out
    tmp = torch.empty_like(keys)
    words = scratch_words(n)
    scratch = torch.zeros(words, dtype=torch.int32, device=keys.device)
    lib = build.load()
    with torch.cuda.device(keys.device):
        status = lib.grs_onesweep_sort_u32(
            keys.data_ptr(), tmp.data_ptr(), out.data_ptr(), n, scratch.data_ptr(), words,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "onesweep sort launch")
    launches += LAUNCHES
    return out
