"""Execution pipelines, ported from ``gpu_radix_sort_tpu/models/pipelines.py``.

  * :class:`FullSortPipeline` — single-device full sort (reference:
    providedGpu path, invokers.cu:45).
  * :class:`PartialSortPipeline` — single-device stable partial sort plus
    boundaries (reference: gpuPartial path, invokers.cu:15).

``build()`` returns the step function and its example inputs, so scripts
and benchmarks share one definition.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import radix_sort
from ..utils.keygen import Pcg32


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
