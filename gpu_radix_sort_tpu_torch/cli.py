"""Command-line entry point (ported subcommands: gen, sort --mode
single|mesh|sample|storage, selftest, worker).

  gen       write the deterministic PCG32 key stream to a raw uint32 file
  sort      sort keys from a raw uint32 file (or generated ones)
  selftest  drive every path end to end, each exact against a numpy oracle
  worker    serve one storage-round event from stdin (the subprocess worker)

The file format is the JAX package's: raw native-endian uint32 keys.
``sort --mode storage`` runs the storage-mediated round loop
(parallel/storage_sort.py) over ``--backend mem|file|device`` with
``--worker local|subprocess|pool``; its knobs fall back to the GRS_*
environment (utils/config.py) when not given.  ``--mode mesh`` and
``--mode sample`` (the LSD and the sample sort) run over every CUDA device,
or one CPU rank with ``--device cpu``; so do the mesh paths of
``selftest``.  Every mode runs on the CUDA device unless ``--device cpu``
is given.
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


def _mesh(device: torch.device):
    """--device cuda: every CUDA device; --device cpu: one CPU rank."""
    from .parallel import key_mesh

    return key_mesh() if device.type == "cuda" else key_mesh([device])


def _sort(keys: np.ndarray, args, device: torch.device) -> torch.Tensor:
    if args.mode == "single":
        from .ops.radix_sort import sort_full

        return sort_full(torch.from_numpy(keys).to(device), strategy=args.strategy)
    from .parallel import sort_distributed, sort_distributed_sample

    mesh = _mesh(device)
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


def _np(x) -> np.ndarray:
    return x if isinstance(x, np.ndarray) else x.cpu().numpy()


def _cmd_selftest(args) -> int:
    """One-round and end-to-end exactness across paths (reference: f.py
    selfTest, f.py:71-144 -- generate, run, verify), on ``--device``: every
    check of the JAX package's ``selftest``, each against a numpy oracle."""
    import tempfile

    from .data.file import FileArrayFactory
    from .data.mem import MemArrayFactory
    from .ops.radix_sort import sort_full, sort_partial
    from .parallel.distributed import sort_distributed
    from .parallel.pipeline import hash_aggregate_distributed
    from .parallel.sample_sort import (
        sort_distributed_64, sort_distributed_sample, sort_key_value_distributed_64,
    )
    from .parallel.serverless import make_subprocess_worker
    from .parallel.storage_sort import (
        make_kv_worker, make_local_worker, sort_distrib_from_raw, sort_distrib_from_raw_kv,
        sort_distrib_from_raw_u64,
    )
    from .utils.checks import (
        boundaries_oracle, check_partial, check_partial_groups, check_sort_full,
    )
    from .utils.keygen import Pcg32, generate_payloads, generate_zipf_keys

    device = torch.device(args.device)
    mesh = _mesh(device)
    n = args.n
    keys = Pcg32().fill(n)
    on_device = torch.from_numpy(keys).to(device)
    failures = []

    def check(name, ok):
        print(f"  {'PASS' if ok else 'FAIL'}  {name}")
        if not ok:
            failures.append(name)

    check("single-chip full sort", check_sort_full(_np(sort_full(on_device)), keys))

    s, b = sort_partial(on_device, 8, 8)
    s = _np(s)
    check("single-chip partial sort", check_partial(s, keys, 8, 8))
    check("boundary contract", np.array_equal(_np(b), boundaries_oracle(s, 8, 8)))

    s_rc, b_rc = sort_partial(on_device, 8, 8, stable=False)
    check(
        "partial sort stable=False (reference contract)",
        check_partial_groups(_np(s_rc), keys, 8, 8) and np.array_equal(_np(b_rc), _np(b)),
    )

    check("mesh LSD sort", check_sort_full(_np(sort_distributed(keys, mesh=mesh)), keys))
    check("mesh sample sort",
          check_sort_full(_np(sort_distributed_sample(keys, mesh=mesh)), keys))
    check(
        "storage sort (mem, local)",
        check_sort_full(
            sort_distrib_from_raw(keys, "st_mem", MemArrayFactory(),
                                  make_local_worker(device=device)), keys,
        ),
    )

    payload = generate_payloads(n, payload_bytes=12)
    gk, gp = sort_distrib_from_raw_kv(
        keys, payload, "st_kv", MemArrayFactory(), make_kv_worker(4 + 12, device=device)
    )
    order = np.argsort(keys, kind="stable")
    check(
        "storage kv sort (mem, 12B rows)",
        np.array_equal(gk, keys[order]) and np.array_equal(gp, payload[order]),
    )

    zk = generate_zipf_keys(max(n // 8, 64), alpha=1.3, seed=2)
    agg_k, agg_c = hash_aggregate_distributed(zk, op="count", mesh=mesh)
    uk, uc = np.unique(zk, return_counts=True)
    o = np.argsort(agg_k, kind="stable")
    check(
        "hash aggregate (Zipf count)",
        np.array_equal(agg_k[o], uk) and np.array_equal(agg_c[o].astype(np.int64), uc),
    )

    fkeys = np.float32(keys.view(np.int32)) / np.float32(997.0)
    got_f = _np(sort_full(torch.from_numpy(fkeys).to(device)))
    check("typed keys (float32 full sort)", np.array_equal(got_f, np.sort(fkeys)))

    agg_k2, agg_c2 = hash_aggregate_distributed(zk, op="count", mesh=mesh, key_order=True)
    check(
        "hash aggregate key_order=True",
        np.array_equal(agg_k2, uk) and np.array_equal(agg_c2.astype(np.int64), uc),
    )

    k64 = (keys.astype(np.uint64) << np.uint64(32)) | np.roll(keys, 1).astype(np.uint64)
    check(
        "distributed 64-bit sort",
        np.array_equal(_np(sort_distributed_64(k64, mesh=mesh)), np.sort(k64)),
    )
    k64s = k64[: max(n // 8, 64)]
    v64 = np.arange(k64s.size, dtype=np.uint32)[:, None]
    gk64, gv64 = sort_key_value_distributed_64(k64s, v64, mesh=mesh)
    o64 = np.argsort(k64s, kind="stable")
    check(
        "distributed 64-bit kv sort",
        np.array_equal(_np(gk64), k64s[o64]) and np.array_equal(_np(gv64), v64[o64]),
    )

    check(
        "storage 64-bit sort (mem)",
        np.array_equal(
            sort_distrib_from_raw_u64(k64s, "st_u64", MemArrayFactory(),
                                      make_kv_worker(8, key_bits=64, device=device)),
            np.sort(k64s),
        ),
    )

    if args.subprocess:
        with tempfile.TemporaryDirectory() as mount:
            check(
                "storage sort (file, subprocess)",
                check_sort_full(
                    sort_distrib_from_raw(
                        keys, "st_sub", FileArrayFactory(mount),
                        make_subprocess_worker(mount, device=device.type), width=16,
                    ),
                    keys,
                ),
            )
    print("selftest:", "OK" if not failures else f"FAILED: {failures}")
    return 1 if failures else 0


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

    t = sub.add_parser("selftest", help="end-to-end exactness checks")
    t.add_argument("--n", type=int, default=100_000)
    t.add_argument("--subprocess", action="store_true",
                   help="include the subprocess-worker path (slow)")
    t.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    t.set_defaults(fn=_cmd_selftest)

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
