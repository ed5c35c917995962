"""One run of a cell: set-up, a closed-loop window of calls, the check.

A run makes the cell's keys on its cards from the seed, builds the entry's
call, warms it up (the first call builds the port's kernels, where the
checkout has not built them yet), and then calls it back to back for the
window: each call starts once the last one has ended on every card.  Each
call is timed twice: by CUDA events on every card's stream, from before its
first launch to after its last (the call's time, the slowest card's), and
by the host clock up to its return, before the synchronise (the enqueue).
The keys sorted over the window's whole time, by the host clock, give the
rate.

One call drawn from the seed and the last call keep their outputs; once
the window has closed, the peak memory has been read and the program's
state is freed, the entry compares them with ``reference.py`` on keys made
again from the seed.
"""

from __future__ import annotations

import gc
import random
import sys
import time
import traceback
from dataclasses import dataclass, field

import torch

from . import cells, keys, trace

WARMUP_CALLS = 3


@dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: cells.Cell
    kind: str  # the cards' name, "cpu" on the CPU
    setup_s: float
    window_s: float
    keys_per_call: int
    call_ms: list[float] = field(default_factory=list)  # start to end on the cards
    enqueue_ms: list[float] = field(default_factory=list)  # start to return, host clock
    peak_bytes: int = 0  # the fullest card's peak in a call, inputs in, the kept sample out
    bytes_per_card: int = 0  # the least bytes a call moves on one card
    trace: trace.Trace | None = None


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            yield from _tensors(item)


class _Cards:
    """The distinct CUDA devices of a run: synchronise, time, peak memory.
    On the CPU (the tests) the host clock stands in and memory reads 0."""

    def __init__(self, devices):
        self.devices = list(dict.fromkeys(d for d in devices if d.type == "cuda"))

    def sync(self) -> None:
        for d in self.devices:
            torch.cuda.synchronize(d)

    def start(self):
        if not self.devices:
            return time.perf_counter()
        marks = []
        for d in self.devices:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(d))
            marks.append(ev)
        return marks

    def stop(self):
        return self.start()

    def elapsed_ms(self, begin, end) -> float:
        if not self.devices:
            return (end - begin) * 1e3
        return max(b.elapsed_time(e) for b, e in zip(begin, end))

    def reset_peaks(self) -> None:
        for d in self.devices:
            torch.cuda.reset_peak_memory_stats(d)

    def peaks(self) -> dict:
        return {d: torch.cuda.max_memory_allocated(d) for d in self.devices}

    def segments(self) -> int:
        return sum(torch.cuda.memory_stats(d).get("segment.all.allocated", 0)
                   for d in self.devices)


def _held_bytes(obj) -> dict:
    out: dict = {}
    for t in _tensors(obj):
        out[t.device] = out.get(t.device, 0) + t.numel() * t.element_size()
    return out


def run(cell: cells.Cell, seed: int, seconds: float, traced: bool, devices,
        t0: float, program=None) -> dict:
    """Run the cell on ``devices`` and return its result line; ``t0`` is the
    host clock at the process's start, ``program`` replaces the entry's
    timed call (the control, and the tests' planted faults)."""
    cards = _Cards(devices)
    cuda = bool(cards.devices)
    entry = cell.entry
    phase = {}

    t = time.perf_counter()
    inputs = keys.make_shards(seed, cell.keys_per_card, devices)
    call = (program or entry.program)(cell, devices)
    cards.sync()
    phase["keys and entry"] = time.perf_counter() - t
    t = time.perf_counter()
    warm, kept = [], None
    for _ in range(WARMUP_CALLS):
        w0 = time.perf_counter()
        out = call(inputs)
        cards.sync()
        kept = out if kept is None else kept  # the pool grows to hold a kept sample
        del out
        warm.append(time.perf_counter() - w0)
    del kept
    phase["warm-up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0
    setup_peak = cards.peaks()

    hold_at = random.Random(f"sortbench:{seed}").random() * 0.5 * seconds
    meas = Run(cell, "", setup_s, 0.0,
               entry.keys_per_call(cell, devices),
               bytes_per_card=entry.bytes_per_card(cell))
    held, held_index, out, failed, marks = None, -1, None, 0, []
    segments = cards.segments()
    cards.reset_peaks()
    session = trace.Session(traced, cuda)
    with session:
        w_start = time.perf_counter()
        deadline = w_start + seconds
        w_end = w_start
        while not marks or time.perf_counter() < deadline:
            out = None
            c0 = time.perf_counter()
            try:
                with session.span(trace.CALL):
                    begin = cards.start()
                    out = call(inputs)
                    c1 = time.perf_counter()
                    end = cards.stop()
                with session.span(trace.WAIT):
                    cards.sync()
            except Exception:  # a failed call ends the window; the run is not correct
                log(traceback.format_exc())
                failed = 1
                break
            w_end = time.perf_counter()
            marks.append((begin, end))
            meas.enqueue_ms.append((c1 - c0) * 1e3)
            if held is None and c0 - w_start >= hold_at:
                held, held_index = out, len(marks) - 1
    meas.window_s = w_end - w_start
    meas.call_ms = [cards.elapsed_ms(b, e) for b, e in marks]
    # every call is alike, and the kept sample was held through the later
    # ones: the window's peak less the sample is a call's peak
    kept = _held_bytes(held) if held_index < len(marks) - 1 else {}
    window_peak = cards.peaks()
    meas.peak_bytes = max((p - kept.get(d, 0) for d, p in window_peak.items()), default=0)
    memory_peak = max([*setup_peak.values(), *window_peak.values()], default=0)
    segments = cards.segments() - segments
    if traced:
        meas.trace = trace.reduce(session.events(), [d.index for d in cards.devices])
    session = None

    kept_calls = [(held_index, held)] if held is not None else []
    if out is not None and out is not held:
        kept_calls.append((len(marks) - 1, out))
    outputs = [o for _, o in kept_calls]
    indices = [i for i, _ in kept_calls]
    del call, inputs, held, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    meas.kind = torch.cuda.get_device_name(cards.devices[0]) if cuda else "cpu"

    log(f"set-up phases: {', '.join(f'{k} {v} s' for k, v in phase.items())}; "
        f"warm-up calls {warm} s; set-up {setup_s} s")
    log(f"window {meas.window_s} s, {len(meas.call_ms)} calls, "
        f"memory segments allocated in the window {segments}")
    if meas.call_ms:
        log(f"calls: first {meas.call_ms[0]} ms, median "
            f"{sorted(meas.call_ms)[len(meas.call_ms) // 2]} ms, max {max(meas.call_ms)} ms")
    log(f"checked calls {indices} of {len(meas.call_ms)}")

    compared = entry.compare(cell, seed, devices, outputs) if outputs else {}
    del outputs
    correct = failed == 0 and bool(compared) and all(v <= lim for v, lim in compared.values())

    metrics = {}
    for metric in cell.metrics(traced):
        value = cells.reader(cell, metric).read(meas)
        if value is not None:
            metrics[metric.name] = {"value": value, "unit": metric.unit}
    device = {"platform": "gpu" if cuda else "cpu", "kind": meas.kind,
              "count": len(devices), "memory_peak_bytes": memory_peak}
    line = {"correct": correct, "attempted": len(meas.call_ms) + failed,
            "failed": failed, "metrics": metrics, "device": device}
    if meas.trace is not None:
        tr = meas.trace
        device["busy_s"] = sum(tr.busy_s.values()) / max(len(tr.busy_s), 1)
        device["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": [list(x) for x in tr.by_name()[:trace.TOP]],
                             "idle_gaps": [list(x) for x in tr.gaps]}
    line["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return line
