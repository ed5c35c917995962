"""Command-line entry point (ported subcommands: gen, sort --mode single|mesh).

  gen    write the deterministic PCG32 key stream to a raw uint32 file
  sort   sort keys from a raw uint32 file (or generated ones)

The file format is the JAX package's: raw native-endian uint32 keys.
Run as ``python -m gpu_radix_sort_tpu_torch``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _cmd_gen(args) -> int:
    from .utils.keygen import Pcg32

    keys = Pcg32().fill(args.n)
    keys.tofile(args.out)
    print(f"wrote {args.n} uint32 keys ({args.n * 4} bytes) to {args.out}")
    return 0


def _load_keys(args) -> np.ndarray:
    if args.infile:
        keys = np.fromfile(args.infile, dtype=np.uint32)
        return keys if args.n is None else keys[: args.n]
    from .utils.keygen import Pcg32

    return Pcg32().fill(args.n if args.n is not None else 1 << 20)


def _sort(keys: np.ndarray, args, device: torch.device) -> torch.Tensor:
    if args.mode == "single":
        from .ops.radix_sort import sort_full

        return sort_full(torch.from_numpy(keys).to(device), strategy=args.strategy)
    from .parallel import key_mesh, sort_distributed

    # --device cuda: every CUDA device; --device cpu: one CPU rank
    mesh = key_mesh() if device.type == "cuda" else key_mesh([device])
    return sort_distributed(
        torch.from_numpy(keys), mesh=mesh,
        width=args.width if args.width is not None else 8,
        exchange=args.exchange, strategy=args.strategy,
    )


def _cmd_sort(args) -> int:
    if args.mode not in ("single", "mesh"):
        raise NotImplementedError(f"sort --mode {args.mode} is not yet ported")
    keys = _load_keys(args)
    device = torch.device(args.device)
    t0 = time.perf_counter()
    got = _sort(keys, args, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    got = got.cpu().numpy()
    rate = keys.size / dt if dt else 0.0
    print(
        f"sorted {keys.size:,} keys on {device} in {dt:.3f}s "
        f"({rate / 1e6:.1f}M keys/s, host clock)",
        file=sys.stderr,
    )
    if args.verify:
        if np.array_equal(got, np.sort(keys)):
            print("verify: EXACT MATCH", file=sys.stderr)
        else:
            print("verify: MISMATCH", file=sys.stderr)
            return 1
    if args.out:
        got.tofile(args.out)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpu_radix_sort_tpu_torch",
        description="Sort framework, PyTorch and CUDA port",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen", help="generate deterministic uint32 keys")
    g.add_argument("--n", type=int, required=True)
    g.add_argument("--out", required=True)
    g.set_defaults(fn=_cmd_gen)

    s = sub.add_parser("sort", help="sort keys")
    s.add_argument("--mode", choices=["single", "mesh", "sample", "storage"],
                   default="single")
    s.add_argument("--n", type=int, default=None)
    s.add_argument("--in", dest="infile", default=None)
    s.add_argument("--out", default=None)
    s.add_argument("--strategy", default=None)
    s.add_argument("--width", type=int, default=None)
    s.add_argument("--exchange", default="auto")
    s.add_argument("--device", default="cuda")
    s.add_argument("--verify", action="store_true")
    s.set_defaults(fn=_cmd_sort)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
