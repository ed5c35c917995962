#!/usr/bin/env python3
"""Times the bitonic networks of gpu_radix_sort_tpu_torch/csrc/block_sort.cu
in other geometries, on one CUDA card: the one-block sort (B3,
single_block_sort_kernel) and the tile pass (B1, block_sort_kernel), both on
register_bitonic.cuh.

    python3 tools/network_variants.py

B3.  Builds a copy of block_sort.cu once for each kSingleRegLog below, in
gpu_radix_sort_tpu_torch/_build/network_variants/:

  r4   16 keys a thread (1024 threads at 2^14 keys): 40 shuffle and 15
       shared-memory stages of 105
  r5   32 keys a thread (512 threads): 35 and 10
  r6   64 keys a thread (256 threads): 30 and 6

prints what ptxas says of the 2^14-key kernel, holds each against the plain
version byte for byte (n from 1 to 2^14, random and duplicate keys), then
prints, twice in turn, the device time of one call (a CUDA graph of 20
calls, median of 10) at 2^14, 4096 and 1000 keys, beside torch.sort of the
pre-flipped int32 keys, each through the C entry point.

B1.  Builds a copy of csrc/ once for each form below, block_sort.cu (and
for one buffer register_bitonic.cuh) patched by TILE_VARIANTS:

  windowed_r5        the windowed network (the shipped form, unpatched): 32
                     keys a thread, 512 threads, one 66 KB buffer,
                     registers capped for two blocks an SM; phases of 2^7
                     and up go through shared memory in round trips that
                     each bring five strides into registers
  shuffles_r5_1buf   B3's network instead (every lane stride by shuffles),
                     one 64 KB buffer and two barriers a shared stage, the
                     same geometry
  shuffles_r5_2buf   the same with two buffers: one block an SM
  shuffles_r4_2buf   16 keys a thread, 1024 threads, two buffers (B3's
                     geometry): one block an SM
  shuffles_r4_1buf   16 keys, one buffer, registers capped at 32 for two
                     blocks an SM

prints ptxas's report of block_sort_kernel, its blocks an SM and its
instruction mix (cuobjdump -sass: opcodes by count), holds each
against the plain version byte for byte (tiles 1 to 2^14, ragged, alternate
on and off), then prints, twice in turn, the CUDA-event median of one tile
pass of 64M keys (tile 2^14, alternate) beside the plain version and
torch.sort of the (n / 2^14, 2^14) rows.  Needs nvcc and a card.
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
from gpu_radix_sort_tpu_torch.ops import block_sort as bs  # noqa: E402
from gpu_radix_sort_tpu_torch.ops import single_block as sb  # noqa: E402
from gpu_radix_sort_tpu_torch.ops.bits import sortable_digits  # noqa: E402
from gpu_radix_sort_tpu_torch.utils import timers  # noqa: E402

MARKER = "constexpr int kSingleRegLog = {}"
VARIANTS = {"r4": 4, "r5": 5, "r6": 6}
SIZES = (1 << 14, 4096, 1000)
N_TILE = 1 << 26


def shuffle_tile_pass(reg_log: int, buffers: int) -> list[tuple[str, str, str]]:
    """The patches that put B1 on B3's network (register_bitonic_sort):
    2^reg_log keys a thread, ``buffers`` shared-memory buffers of 2^14 words
    (one: a second barrier a shared stage, two blocks an SM; two: one block
    an SM)."""
    patches = [
        ("block_sort.cu",
         "  grs::windowed_bitonic_sort<kTileLog, kTileRegLog>(\n"
         "      keys, reinterpret_cast<uint32_t*>(net_buf), tile_log, alternate != 0);",
         "  grs::register_bitonic_sort<kTileLog, kTileRegLog>(keys, net_buf, tile_log,\n"
         "                                                    alternate != 0);"),
        ("block_sort.cu", "constexpr int kTileSharedPhase = kTileRegLog + 2;",
         "constexpr int kTileSharedPhase = kTileRegLog + grs::kLaneLog + 1;"),
        ("block_sort.cu",
         "constexpr int kTileSmem = grs::windowed_words(kTileLog) * (int)sizeof(uint32_t);",
         f"constexpr int kTileSmem = ({buffers} << kTileLog) * (int)sizeof(uint32_t);"),
        ("block_sort.cu", "constexpr int kTileRegLog = 5;",
         f"constexpr int kTileRegLog = {reg_log};"),
    ]
    if buffers == 2:
        return patches + [("block_sort.cu", "constexpr int kTileMinBlocks = 2;",
                           "constexpr int kTileMinBlocks = 1;")]
    loads_end = "        x = lower ? min(x, ys[e]) : max(x, ys[e]);\n      }\n    }\n"
    return patches + [
        ("register_bitonic.cuh", "    uint4* b = buf + parity * kVectors * kThreads;",
         "    uint4* b = buf;"),
        ("register_bitonic.cuh", loads_end, loads_end + "    __syncthreads();\n"),
    ]


TILE_VARIANTS = {
    "windowed_r5": [],
    "shuffles_r5_1buf": shuffle_tile_pass(5, 1),
    "shuffles_r5_2buf": shuffle_tile_pass(5, 2),
    "shuffles_r4_2buf": shuffle_tile_pass(4, 2),
    "shuffles_r4_1buf": shuffle_tile_pass(4, 1),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def ptxas_lines(err: str, key: str) -> list[str]:
    """What ptxas said of the entry whose mangled name holds ``key``."""
    entry, report = False, []
    for line in err.splitlines():
        if "Compiling entry function" in line:
            entry = key in line
        elif entry and ("Used" in line or "spill" in line):
            report.append(line.split(" : ", 1)[-1].strip())
    return report


def sass_mix(lib: Path, key: str) -> str:
    """Opcodes of the kernel whose mangled name holds ``key`` in the
    library's SASS (cuobjdump beside nvcc), most frequent first."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return "cuobjdump not found (not measured)"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    counts: dict[str, int] = {}
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = key in line
        elif inside and "/*" in line and ";" in line:
            text = line.split("*/", 1)[-1].strip()
            words = text.replace("{", " ").split()
            while words and words[0].startswith("@"):
                words = words[1:]
            if words:
                op = words[0].split(".")[0]
                counts[op] = counts.get(op, 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])
    return f"{sum(counts.values())} instructions: " + ", ".join(f"{k} {v}" for k, v in top[:14])


def load_variant(path: Path, entries: tuple[str, ...]) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for entry in entries:
        fn = getattr(lib, entry)
        fn.argtypes = build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return lib


def build_variants(root: Path, source: str, variants: dict[str, list[tuple[str, str, str]]],
                   entries: tuple[str, ...], key: str) -> dict[str, ctypes.CDLL]:
    """One ``nvcc -shared`` of csrc/``source`` for each variant, all in
    parallel, each from a copy of csrc/ under root/<variant> with the
    variant's patches applied: (file, text, replacement), the text present
    once.  Prints ptxas's report of the entry whose mangled name holds
    ``key``, or nvcc's errors for a variant that does not build (left out of
    the result)."""
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, patches in variants.items():
        d = root / name
        d.mkdir(parents=True)
        for f in (build.CSRC / source, *build._headers()):
            shutil.copy(f, d / f.name)
        for file, old, new in patches:
            text = (d / file).read_text()
            assert text.count(old) == 1, f"{file} changed: update the patch {old!r}"
            (d / file).write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-o", str(d / "lib.so"), str(d / source)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:  # a form that does not build is reported and left out
            print(f"build [{name}]: nvcc failed ({proc.returncode}):\n{err[-4000:]}", flush=True)
            continue
        print(f"ptxas [{name}]: {'; '.join(ptxas_lines(err, key))}", flush=True)
        libs[name] = load_variant(root / name / "lib.so", entries)
    return libs


def single_block_study(card: str, dev, rng) -> None:
    committed = MARKER.format(sb.REG_LOG)
    libs = build_variants(
        build.BUILD_DIR / "network_variants", "block_sort.cu",
        {name: [("block_sort.cu", committed, MARKER.format(reg_log))]
         for name, reg_log in VARIANTS.items()},
        ("grs_single_block_sort_u32",), "single_block_sort_kernelILi14E")

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
    print("every one-block variant equal to the plain version byte for byte", flush=True)

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


def tile_pass_study(card: str, dev, rng) -> None:
    root = build.BUILD_DIR / "tile_variants"
    entries = ("grs_block_sort_u32", "grs_block_sort_blocks_per_sm")
    libs = build_variants(root, "block_sort.cu", TILE_VARIANTS, entries, "17block_sort_kernel")
    for name, lib in libs.items():
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        build.check(lib.grs_block_sort_blocks_per_sm(bs.TILE, ctypes.byref(blocks),
                                                     ctypes.byref(smem)), name)
        print(f"occupancy [{name}]: {blocks.value} blocks an SM with {smem.value} bytes "
              f"of dynamic shared memory", flush=True)
        print(f"sass [{name}]: block_sort_kernel "
              f"{sass_mix(root / name / 'lib.so', '17block_sort_kernel')}", flush=True)

    def tile_pass(lib, x, out, tile, alternate) -> None:
        status = lib.grs_block_sort_u32(x.data_ptr(), out.data_ptr(), x.numel(), tile,
                                        int(alternate),
                                        torch.cuda.current_stream().cuda_stream)
        if status:
            raise SystemExit(f"network_variants: CUDA error {status}")

    for tile in (1, 128, 1024, bs.TILE):
        for n in (1, 3 * tile + 5, 4 * bs.TILE + 777, 5 * bs.TILE + 777):
            a = rng.integers(0, 1 << 32, n, dtype=np.uint32)
            x = torch.from_numpy(a).to(dev)
            for alternate in (False, True):
                want = bs.block_sort_plain(x, tile, alternate=alternate)
                for name, lib in libs.items():
                    out = torch.empty_like(x)
                    tile_pass(lib, x, out, tile, alternate)
                    torch.cuda.synchronize()
                    if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                        raise SystemExit(f"network_variants: {name} differs from the plain "
                                         f"version at tile={tile} n={n} alternate={alternate}")
    print("every tile-pass variant equal to the plain version byte for byte", flush=True)

    keys = torch.from_numpy(rng.integers(0, 1 << 32, N_TILE, dtype=np.uint32)).to(dev)
    out = torch.empty_like(keys)
    rows = keys.view(torch.int32).view(-1, bs.TILE)
    for turn in range(2):
        ms_plain = timers.time_cuda(lambda: bs.block_sort_plain(keys, bs.TILE, alternate=True))
        ms_lib = timers.time_cuda(lambda: torch.sort(rows, dim=1))
        print(f"turn {turn} [{card}]: tile pass of {N_TILE} keys, plain {ms_plain:.4f} ms, "
              f"torch.sort of the rows {ms_lib:.4f} ms", flush=True)
        for name, lib in (libs.items() if turn == 0 else reversed(libs.items())):
            t = timers.time_cuda(lambda: tile_pass(lib, keys, out, bs.TILE, True))
            print(f"turn {turn} {name:17s} [{card}]: {t:.4f} ms", flush=True)
    shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("network_variants: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    single_block_study(card, dev, rng)
    tile_pass_study(card, dev, rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
