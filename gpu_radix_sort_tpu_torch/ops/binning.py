"""Stable digit sorts at device-memory scale: binning passes.

Port of ``gpu_radix_sort_tpu/ops/pallas_radix.py``.  One pass by a window of
at most PASS_WIDTH bits:

    stage A   each tile of ``tile`` keys sorted stably by digit: a row-wise
              ``torch.sort(stable=True)`` of narrow digits, a gather of the
              keys, and a batched ``searchsorted`` for the start of each
              digit's run in each tile (XLA ops in the JAX package);
    metadata  run k = d * n_tiles + t (digit d's run of tile t): g_run, the
              exclusive cumsum of the run lengths in that order, and sflat,
              each run's start in the stage-A array (torch ops);
    stage B   :func:`bin_runs`, the wrapper of ``csrc/binning.cu``, which
              replaces ``pallas_radix.py:205`` ``_bin_kernel`` (B5): every run
              goes to its place, so the output is in (digit, tile, rank)
              order, the stable digit order of the input.

Wider windows run as LSD passes of PASS_WIDTH bits.  n is padded to whole
tiles with 0xFFFFFFFF keys (the largest digit of any window, so the pads land
at the tail and are cut off); payload columns pad with 0.

Geometry for this card.  PASS_WIDTH = 4 and TILE = 2^15 keys, the JAX
values: 16 digits keep the runs long (2048 keys on average at TILE = 2^15),
so the scatter of stage B writes mostly whole 128-byte lines, and 4-bit
passes keep the digit sort of stage A at one byte.  Nothing caps the number
of tiles (the TPU's SMEM caps on the metadata are gone): the metadata of a
256Mi-key pass is 2 x 131072 int64.  The kernel takes windows of up to 8
bits, so 8-bit passes can be measured without a new kernel.

On a CPU tensor :func:`bin_runs` runs :func:`bin_runs_plain`, the same
placement by torch indexing; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from ..kernels import build
from ..utils.timers import span
from .bits import KEY_DTYPE, sortable_digits, validate_digit_range
from .block_sort import check_keys, next_pow2

PASS_WIDTH = 4  # bits a pass
TILE = 1 << 15  # stage-A tile (keys)
MAX_WIDTH = 8  # widest window one pass takes (kMaxWidth in csrc/binning.cu)
_PAD = -1  # 0xFFFFFFFF as int32

launches = 0  # kernel launches, for showing that a run went through the kernel


def auto_geometry(n: int) -> int:
    """The tile of a pass over n keys: TILE, or one tile of next_pow2(n)
    keys when n is smaller, so that a small pass pads little."""
    return min(TILE, next_pow2(max(n, 1)))


def _check_width(offset: int, width: int) -> None:
    validate_digit_range(offset, width)
    if width > MAX_WIDTH:
        raise ValueError(
            f"one binning pass takes a window of at most {MAX_WIDTH} bits, got "
            f"{width}; wider windows go through sort_by_digits_large"
        )


# ---------------------------------------------------------------------------
# Stage A and the metadata (torch ops)
# ---------------------------------------------------------------------------

def _stage_a(keys_t: torch.Tensor, offset: int, width: int):
    """(order, sorted keys, starts) of (n_tiles, tile) uint32 keys: order is
    the stable within-row sort permutation, starts[t, d] the within-tile
    start of digit d's run (int32, (n_tiles, 2^width + 1))."""
    nq = (1 << width) + 1
    digits = sortable_digits(keys_t, offset, width, top=nq - 1)
    sorted_digits, order = torch.sort(digits, dim=1, stable=True)
    sorted_keys = keys_t.view(torch.int32).gather(1, order).view(KEY_DTYPE)
    queries = torch.arange(nq, dtype=digits.dtype, device=digits.device)
    starts = torch.searchsorted(
        sorted_digits, queries.expand(keys_t.shape[0], nq).contiguous(),
        side="left", out_int32=True,
    )
    return order, sorted_keys, starts


def tile_digit_sort(keys_t: torch.Tensor, offset: int, width: int):
    """Stably sort each row of (n_tiles, tile) uint32 keys by its digit;
    returns (sorted_keys (n_tiles, tile), starts (n_tiles, 2^width + 1)
    int32), starts[t, d] being the within-tile start of digit d's run."""
    _check_width(offset, width)
    _, sorted_keys, starts = _stage_a(keys_t, offset, width)
    return sorted_keys, starts


def _binning_metadata(starts: torch.Tensor, tile: int):
    """Runs are the (digit, tile) segments of the stage-A array, in output
    order k = d * n_tiles + t.  Returns int64
      g_run (n_runs + 1,)  destination start of run k (g_run[-1] = n_pad);
      sflat (n_runs,)      source start of run k in the stage-A array
                           (t * tile + starts[t, d])."""
    n_tiles = starts.shape[0]
    counts = (starts[:, 1:] - starts[:, :-1]).t().reshape(-1)
    g_run = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=starts.device),
        torch.cumsum(counts, 0, dtype=torch.int64),
    ])
    tbase = torch.arange(n_tiles, dtype=torch.int64, device=starts.device) * tile
    sflat = (starts[:, :-1].t().to(torch.int64) + tbase[None, :]).reshape(-1)
    return g_run, sflat


# ---------------------------------------------------------------------------
# Stage B: the binning kernel
# ---------------------------------------------------------------------------

def bin_runs_plain(
    keys: torch.Tensor, src: torch.Tensor, g_run: torch.Tensor,
    sflat: torch.Tensor, tile: int, offset: int, width: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`bin_runs`: element p of tile t with
    digit d goes to p + g_run[k] - sflat[k], k = d * n_tiles + t."""
    n = keys.numel()
    p = torch.arange(n, dtype=torch.int64, device=keys.device)
    d = sortable_digits(keys, offset, width).to(torch.int64)
    k = d * (n // tile) + p // tile
    out = torch.empty_like(src.view(torch.int32))
    out[p + g_run[k] - sflat[k]] = src.view(torch.int32)
    return out.view(KEY_DTYPE)


def bin_runs(
    keys: torch.Tensor, src: torch.Tensor, g_run: torch.Tensor,
    sflat: torch.Tensor, tile: int, offset: int, width: int,
) -> torch.Tensor:
    """Stage B: place the stage-A elements ``src`` (n a multiple of
    ``tile``), whose digits are bits [offset, offset+width) of the stage-A
    ``keys``, by the run metadata.  ``src`` may be ``keys``.  Returns a new
    tensor."""
    global launches
    check_keys(keys)
    check_keys(src)
    _check_width(offset, width)
    n = keys.numel()
    if n == 0 or tile < 1 or n % tile or src.numel() != n:
        raise ValueError(
            f"keys and src must hold the same whole number of tiles; got "
            f"{n} and {src.numel()} keys, tile {tile}"
        )
    n_runs = (n // tile) << width
    for name, meta, size in (("g_run", g_run, n_runs + 1), ("sflat", sflat, n_runs)):
        if meta.dtype != torch.int64 or meta.shape != (size,) or not meta.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int64 tensor of {size}")
    if {src.device, g_run.device, sflat.device} != {keys.device}:
        raise ValueError("keys, src and the metadata must be on one device")
    if keys.device.type == "cpu":
        return bin_runs_plain(keys, src, g_run, sflat, tile, offset, width)
    out = torch.empty_like(src)
    lib = build.load()
    with torch.cuda.device(keys.device):
        status = lib.grs_binning_u32(
            keys.data_ptr(), src.data_ptr(), out.data_ptr(), n, tile, offset,
            width, g_run.data_ptr(), sflat.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "binning launch")
    launches += 1
    return out


# ---------------------------------------------------------------------------
# Passes
# ---------------------------------------------------------------------------

def _pad(x: torch.Tensor, n_pad: int, value: int) -> torch.Tensor:
    """x (uint32) padded to n_pad with ``value`` (as int32)."""
    x = x.contiguous()
    if x.numel() == n_pad:
        return x
    fill = torch.full((n_pad - x.numel(),), value, dtype=torch.int32, device=x.device)
    return torch.cat([x.view(torch.int32), fill]).view(KEY_DTYPE)


def stage_a(
    keys: torch.Tensor, cols: tuple, offset: int, width: int, tile: int
):
    """Stage A and the metadata of one pass: the keys and (n,) uint32
    columns padded to whole tiles, each tile sorted stably by the keys'
    digits.  Returns (sorted keys, sorted columns, g_run, sflat), all flat."""
    with span("grs.binning.stage_a"):
        n = keys.numel()
        n_tiles = -(-n // tile)
        n_pad = n_tiles * tile
        keys_t = _pad(keys, n_pad, _PAD).view(n_tiles, tile)
        order, sorted_t, starts = _stage_a(keys_t, offset, width)
        sorted_cols = tuple(
            _pad(c, n_pad, 0).view(torch.int32).view(n_tiles, tile).gather(1, order)
            .view(KEY_DTYPE).reshape(-1)
            for c in cols
        )
        del order
        g_run, sflat = _binning_metadata(starts, tile)
        return sorted_t.reshape(-1), sorted_cols, g_run, sflat


def binning_pass_kv_cols(
    keys: torch.Tensor, cols: tuple, offset: int, width: int, *,
    tile: int | None = None,
) -> tuple[torch.Tensor, tuple]:
    """One stable binning pass by bits [offset, offset+width) over the keys
    and (n,) uint32 payload columns: stage A gathers the columns by the
    keys' row order, stage B moves the keys and then each column on the same
    metadata."""
    _check_width(offset, width)
    keys = keys.contiguous()
    check_keys(keys)
    n = keys.numel()
    for c in cols:
        if c.dtype != KEY_DTYPE or c.shape != (n,):
            raise ValueError(f"each payload column must be uint32 ({n},); got "
                             f"{c.dtype} {tuple(c.shape)}")
    if n == 0:
        return keys.clone(), tuple(c.clone() for c in cols)
    tile = tile or auto_geometry(n)
    sorted_keys, sorted_cols, g_run, sflat = stage_a(keys, cols, offset, width, tile)

    def stage_b(src: torch.Tensor) -> torch.Tensor:
        return bin_runs(sorted_keys, src, g_run, sflat, tile, offset, width)[:n]

    with span("grs.binning.place"):
        return stage_b(sorted_keys), tuple(stage_b(c) for c in sorted_cols)


def _columns(lanes: torch.Tensor) -> tuple:
    """The (n,) columns of (n, L) uint32 lanes (copied through int32: the
    CUDA copy of strided uint32 is not one every build has)."""
    words = lanes.view(torch.int32)
    return tuple(words[:, w].contiguous().view(KEY_DTYPE) for w in range(lanes.shape[1]))


def _lanes(cols: tuple) -> torch.Tensor:
    """Inverse of :func:`_columns`."""
    return torch.stack([c.view(torch.int32) for c in cols], dim=1).view(KEY_DTYPE)


def binning_pass_kv(
    keys: torch.Tensor, lanes: torch.Tensor, offset: int, width: int, *,
    tile: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, L)-matrix form of :func:`binning_pass_kv_cols`: one stable pass
    over the keys and the L uint32 lanes of each row."""
    if lanes.dim() != 2 or lanes.shape[0] != keys.shape[0]:
        raise ValueError(
            f"lanes must be (n, L) with n == len(keys); got {tuple(lanes.shape)}"
        )
    out_keys, out_cols = binning_pass_kv_cols(
        keys, _columns(lanes), offset, width, tile=tile
    )
    return out_keys, _lanes(out_cols) if out_cols else lanes


def binning_pass(
    keys: torch.Tensor, offset: int, width: int, *, tile: int | None = None
) -> torch.Tensor:
    """One stable binning pass by bits [offset, offset+width), a window of at
    most MAX_WIDTH bits; wider windows go through
    :func:`sort_by_digits_large`."""
    return binning_pass_kv_cols(keys, (), offset, width, tile=tile)[0]


def sort_key_value_by_digits_large(
    keys: torch.Tensor, cols: tuple, offset: int, width: int, *,
    tile: int | None = None,
) -> tuple[torch.Tensor, tuple]:
    """Stable sort of keys and uint32 payload by bits [offset,
    offset+width), as LSD passes of PASS_WIDTH bits.  ``cols`` is a tuple of
    (n,) columns or an (n, L) matrix; the payload comes back in the same
    form."""
    validate_digit_range(offset, width)
    matrix = isinstance(cols, torch.Tensor) and cols.dim() == 2
    if matrix:
        lanes = cols
        cols = _columns(lanes)
    cols = tuple(cols)
    done = 0
    while done < width:
        w = min(PASS_WIDTH, width - done)
        keys, cols = binning_pass_kv_cols(keys, cols, offset + done, w, tile=tile)
        done += w
    if matrix:
        return keys, _lanes(cols) if cols else lanes
    return keys, cols


def sort_by_digits_large(
    keys: torch.Tensor, offset: int, width: int, *, tile: int | None = None
) -> torch.Tensor:
    """Stable sort by bits [offset, offset+width) as LSD passes of
    PASS_WIDTH bits (stable passes compose to a stable sort of the whole
    window)."""
    return sort_key_value_by_digits_large(keys, (), offset, width, tile=tile)[0]
