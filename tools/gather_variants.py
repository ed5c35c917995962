#!/usr/bin/env python3
"""Times ways of moving payload rows by a permutation on one CUDA card: the
last step of a key-value sort whose binning passes carried a row index
(gpu_radix_sort_tpu_torch/ops/radix_sort.py, _gather_rows).

    python3 tools/gather_variants.py

For rows of 8, 16 and 64 bytes (2^27 rows; 16-byte rows also at 2^28, the
(n, 4)-lane digit sort's size) and two orders -- a random permutation (the
order of a full key sort) and the stable order of 8-bit digits (256
interleaved increasing runs, a w8 digit sort's) -- it prints the CUDA-event
median of 10 of:

  index_select i32   rows as int32 words, index_select on dim 0 (int32 order)
  index_select i64w  rows as int64 words, index_select on dim 0
  gather i32         torch.gather of int32 words by the order expanded
                     along the row (a stride-0 view, no copy)
  gather i64         the same on int64 words
  gather 16B         the same on 16-byte words (complex128 view)
  index i64w         advanced indexing rows[order] of int64 words
  gather ... materialized   the same by a contiguous copy of that index
  port _gather_rows  the port's row gather, as the key-value sorts run it
  copy_              the same bytes copied in order (the yardstick)

each result held against index_select's, with the bytes bound (each row
read once and written once at 3.35 TB/s).  Needs a card.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

sys.path.insert(0, __import__("pathlib").Path(__file__).resolve().parents[1].as_posix())

from gpu_radix_sort_tpu_torch.ops.radix_sort import _gather_rows  # noqa: E402
from gpu_radix_sort_tpu_torch.utils import timers  # noqa: E402

PEAK_BYTES = 3.35e12


def variants(rows: torch.Tensor, o32: torch.Tensor, o64: torch.Tensor) -> dict:
    """name -> function of the rows (n, B) uint8 moved by the order."""
    n, nbytes = rows.shape
    words = {4: rows.view(torch.int32), 8: rows.view(torch.int64)}
    if nbytes % 16 == 0:
        words[16] = rows.view(torch.complex128)
    out = {
        "index_select i32": lambda: words[4].index_select(0, o32),
        "index_select i64w": lambda: words[8].index_select(0, o32),
        "gather i32": lambda: torch.gather(words[4], 0, o64[:, None].expand(n, nbytes // 4)),
        "gather i64": lambda: torch.gather(words[8], 0, o64[:, None].expand(n, nbytes // 8)),
        "index i64w": lambda: words[8][o64],
    }
    if 16 in words:
        out["gather 16B"] = lambda: torch.gather(words[16], 0, o64[:, None].expand(n, nbytes // 16))
        out["gather 16B materialized"] = lambda: torch.gather(
            words[16], 0, o64[:, None].expand(n, nbytes // 16).contiguous())
    out["gather i32 materialized"] = lambda: torch.gather(
        words[4], 0, o64[:, None].expand(n, nbytes // 4).contiguous())
    out["port _gather_rows"] = lambda: _gather_rows(rows, o32)
    target = torch.empty_like(rows)
    out["copy_"] = lambda: target.copy_(rows)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_variants: needs a CUDA device", file=sys.stderr)
        return 1
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    for n, nbytes in ((1 << 27, 8), (1 << 27, 16), (1 << 28, 16), (1 << 27, 64)):
        rows = torch.from_numpy(rng.integers(0, 256, (n, nbytes), dtype=np.uint8)).to(dev)
        digits = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(dev)
        orders = {"random": torch.randperm(n, device=dev),
                  "w8 digits": torch.sort(digits, stable=True).indices}
        del digits
        b = 2 * n * nbytes / PEAK_BYTES * 1e3
        for oname, o64 in orders.items():
            o32 = o64.to(torch.int32)
            fns = variants(rows, o32, o64)
            want = fns["index_select i32"]().view(torch.uint8)
            line = []
            for name, fn in fns.items():
                if name != "copy_" and not torch.equal(fn().view(torch.uint8).view(n, nbytes),
                                                       want.view(n, nbytes)):
                    raise SystemExit(f"gather_variants: {name} differs from index_select")
                line.append(f"{name} {timers.time_cuda(fn):.3f}")
            print(f"[{card}] {n} rows of {nbytes} B, {oname} order (bound {b:.3f} ms): "
                  + "; ".join(line) + " ms", flush=True)
            del want, fns, o32
        del rows, orders
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
