"""Timers: the median of k runs after warm-up.

:func:`time_cuda` reads CUDA events around each run on the current stream
(PyTorch returns before the device finishes, so a host clock would time the
enqueue); it needs a card.  :func:`time_wall` reads the host clock and is
for the CPU.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def time_cuda(fn: Callable[[], object], *, warmup: int = 2, iters: int = 10) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def time_wall(fn: Callable[[], object], *, warmup: int = 1, iters: int = 5) -> float:
    """Median milliseconds of ``fn()`` by the host clock."""
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)
