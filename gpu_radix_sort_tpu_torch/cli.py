"""Command-line entry point (ported subcommands: gen, sort --mode
single|mesh|sample|storage, worker).

  gen     write the deterministic PCG32 key stream to a raw uint32 file
  sort    sort keys from a raw uint32 file (or generated ones)
  worker  serve one storage-round event from stdin (the subprocess worker)

The file format is the JAX package's: raw native-endian uint32 keys.
``sort --mode storage`` runs the storage-mediated round loop
(parallel/storage_sort.py) over ``--backend mem|file|device`` with
``--worker local|subprocess|pool``; its knobs fall back to the GRS_*
environment (utils/config.py) when not given.  ``--mode mesh`` and
``--mode sample`` (the LSD and the sample sort) run over every CUDA device,
or one CPU rank with ``--device cpu``.  Every mode runs on the CUDA device
unless ``--device cpu`` is given.
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


def _sort_storage(keys: np.ndarray, args) -> np.ndarray:
    from .parallel.storage_sort import sort_distrib_from_raw
    from .utils.config import SortConfig

    explicit = {
        k: v
        for k, v in dict(
            width=args.width, nworker=args.nworker, strategy=args.strategy,
            backend=args.backend, worker=args.worker, mount=args.mount,
            checkpoint_dir=args.checkpoint_dir, device=args.device,
        ).items()
        if v is not None  # unset flags must not clobber GRS_* env
    }
    cfg = SortConfig.from_env(**explicit).validate()
    pool = cfg.make_worker_pool() if cfg.worker == "pool" else None
    try:
        worker = pool.worker() if pool is not None else cfg.make_worker()
        return sort_distrib_from_raw(
            keys, "cli", cfg.make_factory(), worker, width=cfg.width,
            nworker=cfg.nworker, checkpoint_dir=cfg.checkpoint_dir,
        )
    finally:
        if pool is not None:
            pool.close()


def _sort(keys: np.ndarray, args, device: torch.device) -> torch.Tensor:
    if args.mode == "single":
        from .ops.radix_sort import sort_full

        return sort_full(torch.from_numpy(keys).to(device), strategy=args.strategy)
    from .parallel import key_mesh, sort_distributed, sort_distributed_sample

    # --device cuda: every CUDA device; --device cpu: one CPU rank
    mesh = key_mesh() if device.type == "cuda" else key_mesh([device])
    if args.mode == "sample":
        return sort_distributed_sample(torch.from_numpy(keys), mesh=mesh)
    return sort_distributed(
        torch.from_numpy(keys), mesh=mesh,
        width=args.width if args.width is not None else 8,
        exchange=args.exchange, strategy=args.strategy,
    )


def _cmd_sort(args) -> int:
    keys = _load_keys(args)
    device = torch.device(args.device or "cuda")
    t0 = time.perf_counter()
    if args.mode == "storage":
        got = _sort_storage(keys, args)
    else:
        got = _sort(keys, args, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    got = got if isinstance(got, np.ndarray) else got.cpu().numpy()
    rate = keys.size / dt if dt else 0.0
    print(
        f"sorted {keys.size:,} keys via {args.mode} on {device} in {dt:.3f}s "
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


def _cmd_worker(_args) -> int:
    from .parallel.worker_main import main as worker_main

    return worker_main()


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
    # storage-mode knobs default to None (= not given), so that the GRS_*
    # environment keeps its precedence: flag > env > default
    s.add_argument("--strategy", default=None)
    s.add_argument("--width", type=int, default=None)
    s.add_argument("--exchange", default="auto")
    s.add_argument("--nworker", type=int, default=None)
    s.add_argument("--backend", default=None, help="storage: mem | file | device")
    s.add_argument("--worker", default=None, help="storage: local | subprocess | pool")
    s.add_argument("--mount", default=None, help="storage: the file backend's root")
    s.add_argument("--checkpoint-dir", default=None)
    s.add_argument("--device", default=None, help="cuda (default) or cpu")
    s.add_argument("--verify", action="store_true")
    s.set_defaults(fn=_cmd_sort)

    w = sub.add_parser("worker", help="serve one storage-round event from stdin")
    w.add_argument("--serve", action="store_true",
                   help="serve line-delimited events until EOF")
    w.set_defaults(fn=_cmd_worker)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
