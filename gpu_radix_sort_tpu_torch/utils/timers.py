"""Timers: the median of k runs after warm-up, and named run phases.

:func:`time_cuda` reads CUDA events around each run on the current stream
(PyTorch returns before the device finishes, so a host clock would time the
enqueue); it needs a card.  :func:`time_wall` reads the host clock and is
for the CPU.

:class:`PerfTimer` and :class:`SortStats` are the JAX package's
(``gpu_radix_sort_tpu/utils/timers.py``; the reference's PerfTimer /
SortStats, benchmark/pkg/benchmark/util.go:23-86): host-clock samples of
named phases, as the storage round loop reports them (``split``,
``workers``, ``checkpoint``, ``destroy``, ``stage_input``, ``linearize``,
and in the fused device loops ``round_sort``, ``counts_d2h``, ``commit``).
A phase that ends in device work synchronizes before it closes, so its host
time covers the device's.

:func:`span` marks a step of the program on the profiler's timeline: where
a ``torch.profiler`` runs, a ``record_function`` range (a user annotation in
the same trace as the device's kernels and copies, so on their clock, its
parent the span around it on the thread); where none runs, one shared null
context, so a span costs one attribute read and keeps nothing.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A span named ``name`` (``grs.<layer>[.<step>]``) around the host code
    that enqueues a step's work: ``record_function(name)`` under a running
    profiler, else the shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _autograd_profiler.record_function(name)


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


@dataclass
class PerfTimer:
    """Accumulates repeated host-clock timings of one phase."""

    name: str = ""
    samples_s: list[float] = field(default_factory=list)

    @contextlib.contextmanager
    def record(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples_s.append(time.perf_counter() - t0)

    @property
    def total_s(self) -> float:
        return sum(self.samples_s)

    @property
    def mean_s(self) -> float:
        return statistics.fmean(self.samples_s) if self.samples_s else 0.0

    @property
    def stdev_s(self) -> float:
        return statistics.stdev(self.samples_s) if len(self.samples_s) > 1 else 0.0


@dataclass
class SortStats:
    """Per-run named phase timers and counters."""

    timers: dict[str, PerfTimer] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)

    def timer(self, name: str) -> PerfTimer:
        if name not in self.timers:
            self.timers[name] = PerfTimer(name)
        return self.timers[name]

    def time(self, name: str):
        return self.timer(name).record()

    def add(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def report(self) -> dict:
        out = {
            name: {
                "total_s": t.total_s,
                "mean_s": t.mean_s,
                "stdev_s": t.stdev_s,
                "n": len(t.samples_s),
            }
            for name, t in self.timers.items()
        }
        out.update({f"counter:{k}": v for k, v in self.counters.items()})
        return out

    def dumps(self) -> str:
        return json.dumps(self.report(), sort_keys=True)
