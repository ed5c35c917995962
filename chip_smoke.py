#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels of gpu_radix_sort_tpu_torch/csrc with nvcc;
3. holds block_sort and merge_level against their plain PyTorch versions,
   byte for byte, at small shapes and at the shapes of the main path;
4. drives the main path -- sort_full of 64M PCG32 keys -- with the launch
   counts set to 0 just before and read just after, exact against np.sort;
   then a ragged n, the one-block route, int32/float32 keys and
   sort_partial(stable=False) against the reference's boundary contract;
5. times sort_full, torch.sort, the tile pass, one merge level and the
   one-block route by the CUDA-event median.

Prints one JSON line of per-kernel results, then, as the last line,
{"ok": true, "device": {...}}.  Any failed check raises and exits non-zero.
Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN = 1 << 26  # 64M keys, 256 MiB: the main path's size


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def total_order_np(a: np.ndarray) -> np.ndarray:
    """numpy IEEE-754 totalOrder bits of float32 keys (independent of the
    port's torch codec)."""
    u = a.view(np.uint32)
    return u ^ np.where(u >> np.uint32(31), np.uint32(0xFFFFFFFF), np.uint32(0x80000000))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    from gpu_radix_sort_tpu_torch.kernels import build
    from gpu_radix_sort_tpu_torch.ops import block_sort as bs
    from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
    from gpu_radix_sort_tpu_torch.ops import radix_sort as rs
    from gpu_radix_sort_tpu_torch.ops.bits import to_int64
    from gpu_radix_sort_tpu_torch.utils import checks, keygen, timers

    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)

    t0 = time.perf_counter()
    build.load()
    log(f"build: {build.library_path().name} ready in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")

    TILE = bs.TILE
    rng = np.random.default_rng(1)

    def on_card(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def inputs(n: int):
        yield "random", rng.integers(0, 1 << 32, n, dtype=np.uint32)
        yield "equal", np.full(n, 0x9E3779B9, np.uint32)
        yield "all-max", np.full(n, 0xFFFFFFFF, np.uint32)

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
    err_block, cases = 0, 0
    for n in small_n:
        for tile in sorted({bs.next_pow2(n), 128}):
            for alternate in (False, True):
                for name, a in inputs(n):
                    x = on_card(a)
                    err_block = max(err_block, compare(
                        bs.block_sort(x, tile, alternate=alternate),
                        bs.block_sort_plain(x, tile, alternate=alternate),
                        f"block_sort n={n} tile={tile} alternate={alternate} {name}",
                    ))
                    cases += 1
    big = on_card(rng.integers(0, 1 << 32, N_MAIN, dtype=np.uint32))
    err_block = max(err_block, compare(
        bs.block_sort(big, TILE, alternate=True),
        bs.block_sort_plain(big, TILE, alternate=True),
        f"block_sort n={N_MAIN} tile={TILE} alternate=True",
    ))
    log(f"block_sort: {cases + 1} cases equal to the plain version byte for byte "
        f"(n in {small_n} and {N_MAIN}; tiles; alternate on/off; random/equal/all-max)")

    # -- merge_level against its plain version -----------------------------
    err_merge, cases = 0, 0
    merge_ls = (128, 1000, ms.B_OUT)
    for n in small_n:
        for L in merge_ls:
            for name, a in inputs(n):
                runs = bs.sort_runs_plain(on_card(a), L, alternate=True)
                err_merge = max(err_merge, compare(
                    ms.merge_level(runs, L), ms.merge_level_plain(runs, L),
                    f"merge_level n={n} L={L} {name}",
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
        f"(L in {merge_ls} at n in {small_n}; L in {(TILE, 1 << 20, N_MAIN // 2)} "
        f"at n={N_MAIN})")

    # -- the main path -------------------------------------------------------
    keygen.reset_global_stream()
    keys_np = keygen.generate_keys(N_MAIN)
    keys = on_card(keys_np)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    bs.launches = 0
    ms.launches = 0
    t0 = time.perf_counter()
    out = rs.sort_full(keys)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {"block_sort": bs.launches, "merge_level": ms.launches}
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2**20
    levels = (N_MAIN // TILE - 1).bit_length()
    log(f"main path: sort_full of {N_MAIN} PCG32 keys, launches {launches} "
        f"(merge levels expected {levels}); first call {first_ms:.1f} ms by host "
        f"clock; peak device memory {peak_mib:.0f} MiB above the "
        f"{keys.numel() * 4 / 2**20:.0f} MiB of keys")
    if launches["block_sort"] < 1 or launches["merge_level"] != levels:
        fail(f"main path launches {launches}, expected block_sort >= 1 and "
             f"merge_level == {levels}")
    if not checks.check_sort_full(out.cpu().numpy(), keys_np):
        fail("sort_full of 64M keys differs from np.sort")
    log("main path: exact against np.sort")

    n_ragged = N_MAIN - 12345
    out = rs.sort_full(keys[:n_ragged])
    if not checks.check_sort_full(out.cpu().numpy(), keys_np[:n_ragged]):
        fail(f"sort_full of {n_ragged} keys differs from np.sort")
    del out

    bs.launches = 0
    ms.launches = 0
    n_small = TILE - 3
    out = rs.sort_full(keys[:n_small])
    if (bs.launches, ms.launches) != (1, 0):
        fail(f"n={n_small} took {bs.launches} block and {ms.launches} merge launches")
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
    log(f"routes: ragged n={n_ragged} exact; n={n_small} one block exact; "
        f"int32 and float32 at {n_typed} exact; sort_partial(8, 8, stable=False) "
        f"at {n_part} meets the group and boundary contract")

    # -- times -----------------------------------------------------------------
    ms_sort = timers.time_cuda(lambda: rs.sort_full(keys))
    ms_torch = timers.time_cuda(lambda: rs.sort_full(keys, strategy="torch"))
    ms_block = timers.time_cuda(lambda: bs.block_sort(keys, TILE, alternate=True))
    ms_block_plain = timers.time_cuda(
        lambda: bs.block_sort_plain(keys, TILE, alternate=True))
    runs = bs.block_sort(keys, TILE, alternate=True)
    ms_merge = timers.time_cuda(lambda: ms.merge_level(runs, TILE))
    ms_merge_plain = timers.time_cuda(lambda: ms.merge_level_plain(runs, TILE))
    one_block = keys[:TILE]
    ms_single = timers.time_cuda(lambda: bs.sort_single_block(one_block))
    ms_single_plain = timers.time_cuda(lambda: bs.block_sort_plain(one_block, TILE))
    top = bs.sort_runs_plain(keys, N_MAIN // 2, alternate=True)
    ms_merge_top = timers.time_cuda(lambda: ms.merge_level(top, N_MAIN // 2))
    rate = lambda t: N_MAIN / (t * 1e-3)  # noqa: E731
    log(f"time [{card}]: sort_full {N_MAIN} keys {ms_sort:.3f} ms "
        f"({rate(ms_sort):.4g} keys/s); median of 10 by CUDA events")
    log(f"time [{card}]: torch.sort (strategy='torch') {ms_torch:.3f} ms "
        f"({rate(ms_torch):.4g} keys/s)")
    log(f"time [{card}]: block_sort pass (tile {TILE}) {ms_block:.3f} ms; "
        f"plain {ms_block_plain:.3f} ms")
    log(f"time [{card}]: merge_level L={TILE} {ms_merge:.3f} ms; plain "
        f"{ms_merge_plain:.3f} ms; L={N_MAIN // 2} {ms_merge_top:.3f} ms "
        f"({2 * 4 * N_MAIN / (ms_merge * 1e-3) / 1e9:.4g} GB/s moved at L={TILE})")
    log(f"time [{card}]: one-block sort_full of {TILE} keys {ms_single:.4f} ms; "
        f"plain {ms_single_plain:.4f} ms")

    print(json.dumps({"kernels": [
        {"name": "block_sort", "route": "cuda",
         "source": "gpu_radix_sort_tpu_torch/csrc/block_sort.cu",
         "replaces": "gpu_radix_sort_tpu/ops/pallas_merge.py:131",
         "also_replaces": "gpu_radix_sort_tpu/ops/pallas_sort.py:180",
         "launches": launches["block_sort"], "max_abs_err": err_block,
         "ms": ms_block, "plain_ms": ms_block_plain,
         "one_block_ms": ms_single, "one_block_plain_ms": ms_single_plain},
        {"name": "merge_level", "route": "cuda",
         "source": "gpu_radix_sort_tpu_torch/csrc/merge_path.cu",
         "replaces": "gpu_radix_sort_tpu/ops/pallas_merge.py:335",
         "launches": launches["merge_level"], "max_abs_err": err_merge,
         "ms": ms_merge, "plain_ms": ms_merge_plain},
    ], "sort_full_ms": ms_sort, "torch_sort_ms": ms_torch, "n": N_MAIN,
        "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
