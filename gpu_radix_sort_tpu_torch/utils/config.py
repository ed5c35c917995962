"""Framework configuration.

Port of ``gpu_radix_sort_tpu/utils/config.py``: the reference's behavior is
spread across compile-time macros (MAX_BLOCK_SZ, sort.cu:5), Go constants
(nworker=2, distrib.go:107), a settable global (SetWidth, distrib.go:14-18)
and environment variables (RADIXBENCH_ROOTPATH, OL_SHARED_VOLUME,
CUDA_VISIBLE_DEVICES); this is one explicit config object for the CLI.

Precedence: explicit constructor args > environment (GRS_*) > defaults.
The port adds ``device`` (``GRS_DEVICE``): the device the sorts and the
device backend run on, the CUDA device unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass


def _env(name: str, default, cast):
    raw = os.environ.get(f"GRS_{name}")
    if raw is None:
        return default
    try:
        return cast(raw)
    except ValueError as e:
        raise ValueError(f"bad GRS_{name}={raw!r}: {e}") from e


@dataclass
class SortConfig:
    """Everything tunable about a sort run, in one place."""

    # Digit width per distributed round (reference: SetWidth, distrib.go:14).
    width: int = 8
    # Storage-plane worker count (reference hard-codes 2, distrib.go:107).
    nworker: int = 2
    # Single-device sort strategy: auto | torch (ops/radix_sort._VALID).
    strategy: str = "auto"
    # Mesh-path bucket exchange (parallel/distributed._VALID_EXCHANGE).
    exchange: str = "auto"
    # All-to-all per-peer slot headroom over the even split.
    capacity_factor: float = 1.25
    # Storage backend for the storage-mediated path: mem | file | device.
    backend: str = "mem"
    # File-backend root; the subprocess-worker rendezvous
    # (reference: OL_SHARED_VOLUME, benchmark.go:79).
    mount: str | None = None
    # Worker kind for the storage-mediated path: local | subprocess | pool.
    # "pool" keeps worker processes (and their CUDA contexts) across
    # rounds; "subprocess" spawns one an invocation (the reference's model).
    worker: str = "local"
    # Per-round persistence (checkpoint/resume); None disables.
    checkpoint_dir: str | None = None
    # torch.profiler trace output dir; None disables.
    trace_dir: str | None = None
    # Device of the sorts, the device backend and the worker processes.
    device: str = "cuda"

    @classmethod
    def from_env(cls, **overrides) -> "SortConfig":
        cfg = cls(
            width=_env("WIDTH", cls.width, int),
            nworker=_env("NWORKER", cls.nworker, int),
            strategy=_env("STRATEGY", cls.strategy, str),
            exchange=_env("EXCHANGE", cls.exchange, str),
            capacity_factor=_env("CAPACITY_FACTOR", cls.capacity_factor, float),
            backend=_env("BACKEND", cls.backend, str),
            mount=_env("MOUNT", cls.mount, str),
            worker=_env("WORKER", cls.worker, str),
            checkpoint_dir=_env("CHECKPOINT_DIR", cls.checkpoint_dir, str),
            trace_dir=_env("TRACE_DIR", cls.trace_dir, str),
            device=_env("DEVICE", cls.device, str),
        )
        return dataclasses.replace(cfg, **overrides)

    def validate(self) -> "SortConfig":
        from ..ops import radix_sort as _rs  # the port's own lists; no drift
        from ..parallel import distributed as _dist

        if self.width <= 0 or 32 % self.width:
            raise ValueError(f"width {self.width} must divide 32")
        if self.nworker < 1:
            raise ValueError(f"nworker must be >= 1, got {self.nworker}")
        if self.strategy not in _rs._VALID:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.exchange not in _dist._VALID_EXCHANGE:
            raise ValueError(f"unknown exchange {self.exchange!r}")
        if self.backend not in ("mem", "file", "device"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.worker not in ("local", "subprocess", "pool"):
            raise ValueError(f"unknown worker {self.worker!r}")
        if self.worker in ("subprocess", "pool") and self.backend != "file":
            raise ValueError(f"{self.worker} workers require backend='file'")
        if self.backend == "file" and not self.mount:
            raise ValueError("backend='file' requires mount")
        if self.device.split(":")[0] not in ("cuda", "cpu"):
            raise ValueError(f"unknown device {self.device!r}")
        return self

    def make_factory(self):
        from ..data import DeviceArrayFactory, FileArrayFactory, MemArrayFactory

        if self.backend == "mem":
            return MemArrayFactory()
        if self.backend == "device":
            return DeviceArrayFactory(self.device)
        return FileArrayFactory(self.mount)

    def make_worker(self):
        """A DistribWorker per the config.  For worker='pool' prefer
        :meth:`make_worker_pool` (caller-managed lifetime); this method
        returns a worker whose pool lives until process exit."""
        from ..parallel.serverless import make_subprocess_worker
        from ..parallel.storage_sort import make_local_worker

        if self.worker == "pool":
            return self.make_worker_pool().worker()
        if self.worker == "subprocess":
            return make_subprocess_worker(self.mount, device=self.device)
        return make_local_worker(
            None if self.strategy == "auto" else self.strategy, device=self.device
        )

    def make_worker_pool(self):
        from ..parallel.serverless import WorkerPool

        return WorkerPool(self.mount, size=self.nworker, device=self.device)
