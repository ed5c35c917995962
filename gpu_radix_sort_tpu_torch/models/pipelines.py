"""Execution pipelines, ported from ``gpu_radix_sort_tpu/models/pipelines.py``.

  * :class:`FullSortPipeline` — single-device full sort (reference:
    providedGpu path, invokers.cu:45).
  * :class:`PartialSortPipeline` — single-device stable partial sort plus
    boundaries (reference: gpuPartial path, invokers.cu:15).
  * :class:`DistributedSortPipeline` — the mesh LSD sort over sharded keys
    (reference: SortDistribFromRaw, distrib.go:183-248), or the sample sort
    (PSRS).
  * :class:`HashAggregatePipeline` — the distributed hash-partition ->
    filter -> aggregate over Zipf keys (BASELINE.json config 5).

``build()`` returns the step function and its example inputs, so scripts
and benchmarks share one definition.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import radix_sort
from ..parallel import distributed, pipeline, sample_sort
from ..parallel.mesh import key_mesh, shard
from ..utils.keygen import Pcg32, generate_zipf_keys


@dataclass
class FullSortPipeline:
    n: int = 1 << 20
    strategy: str | None = None
    device: str | torch.device = "cuda"

    def build(self):
        strategy = self.strategy

        def step(keys: torch.Tensor) -> torch.Tensor:
            return radix_sort.sort_full(keys, strategy=strategy)

        example = torch.from_numpy(Pcg32().fill(self.n)).to(self.device)
        return step, (example,)


@dataclass
class PartialSortPipeline:
    n: int = 1 << 20
    offset: int = 0
    width: int = 8
    strategy: str | None = None
    device: str | torch.device = "cuda"

    def build(self):
        offset, width, strategy = self.offset, self.width, self.strategy

        def step(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
            return radix_sort.sort_partial(keys, offset, width, strategy=strategy)

        example = torch.from_numpy(Pcg32().fill(self.n)).to(self.device)
        return step, (example,)


@dataclass
class HashAggregatePipeline:
    """Skew-aware distributed group-by (BASELINE.json config 5) over a mesh
    (default: every CUDA device): hash partition with sampled splitters,
    local combine and global aggregate of ``n_local`` Zipf keys a rank
    (seed 9) with float32 ones as values, every row valid."""

    n_local: int = 1 << 14
    op: str = "count"
    zipf_alpha: float = 1.2
    capacity_factor: float = 2.0
    mesh: object = None

    def build(self):
        mesh = self.mesh or key_mesh()
        n = self.n_local * mesh.size
        fn, _ = pipeline.build_hash_aggregate(
            mesh, self.n_local, op=self.op, capacity_factor=self.capacity_factor
        )
        keys = torch.from_numpy(generate_zipf_keys(n, alpha=self.zipf_alpha, seed=9))
        vals = torch.ones(n, dtype=torch.float32)
        valid = torch.ones(n, dtype=torch.bool)
        return fn, (shard(keys, mesh), shard(vals, mesh), shard(valid, mesh))


@dataclass
class DistributedSortPipeline:
    """The distributed sort over a mesh (default: every CUDA device) with
    the keys sharded over it.  ``algorithm="lsd"`` is the reference-parity
    32/width radix rounds; ``"sample"`` is PSRS, one local sort and one
    splitter exchange, whose capacity factor is raised to at least 1.5
    (splitter balance is approximate, and lower factors overflow on
    ordinary inputs)."""

    n_local: int = 1 << 16
    width: int = 8
    algorithm: str = "lsd"
    exchange: str = "alltoall"
    capacity_factor: float = 1.25
    strategy: str | None = None
    mesh: object = None

    def build(self):
        if self.algorithm not in ("lsd", "sample"):
            raise ValueError(f"algorithm must be 'lsd' or 'sample', got {self.algorithm!r}")
        mesh = self.mesh or key_mesh()
        if self.algorithm == "sample":
            # PSRS takes no digit width, exchange or strategy: say so rather
            # than measure another configuration ("auto", sort_distributed's
            # default exchange, counts as unset too)
            if self.strategy is not None or self.exchange not in ("alltoall", "auto"):
                raise ValueError(
                    "algorithm='sample' ignores strategy/exchange; leave "
                    "them at defaults or use algorithm='lsd'"
                )
            fn, _ = sample_sort.build_sample_sort(
                mesh, self.n_local, capacity_factor=max(self.capacity_factor, 1.5)
            )
        else:
            fn = distributed.build_distributed_sort(
                mesh,
                self.n_local,
                width=self.width,
                exchange=self.exchange,
                capacity_factor=self.capacity_factor,
                strategy=self.strategy,
            )
        keys = torch.from_numpy(Pcg32().fill(self.n_local * mesh.size))
        return fn, (shard(keys, mesh),)
