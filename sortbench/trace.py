"""The traced window: the harness's spans, and the device trace reduced.

With ``--trace 1`` the window runs under ``torch.profiler`` (host and CUDA
activities).  The harness marks each call with two spans of its own:
``sortbench.call`` from the call's start to its return (the enqueue) and
``sortbench.wait`` over the synchronise that ends it.  The raw profiler
events are read directly (``kineto_results.events()``), without the
profiler's own per-event tables, and reduced to what the metric readers
need: every device operation (kernel, copy, memset) with its card and
times, each card's busy time, and the longest idle gaps of the cards,
labelled by what the host was doing then.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from dataclasses import dataclass
from pathlib import Path

CALL = "sortbench.call"
WAIT = "sortbench.wait"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10  # entries of each list of the breakdown


@dataclass
class Trace:
    window_s: float
    calls: int  # harness calls inside the traced window
    cards: list[int]
    ops: list[tuple[int, str, int, int]]  # (card, name, start_ns, end_ns)
    busy_s: dict[int, float]  # union of the card's operations in the window
    gaps: list[tuple[str, float]]  # the longest idle gaps, labelled

    def op_seconds(self, select) -> dict[int, float]:
        """Seconds of the operations whose name ``select`` accepts, by card."""
        out = {c: 0.0 for c in self.cards}
        for card, name, t0, t1 in self.ops:
            if select(name):
                out[card] += (t1 - t0) * 1e-9
        return out

    def by_name(self) -> list[tuple[str, float]]:
        """Device seconds by operation name, summed over the cards, most
        first."""
        total: dict[str, float] = {}
        for _, name, t0, t1 in self.ops:
            key = short_name(name)
            total[key] = total.get(key, 0.0) + (t1 - t0) * 1e-9
        return sorted(total.items(), key=lambda kv: -kv[1])


class Session:
    """The profiler over the window, or nothing where tracing is off.
    ``span(name)`` marks a host interval in the trace."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        self.prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def events(self) -> list:
        return list(self.prof.profiler.kineto_results.events())


def short_name(name: str) -> str:
    """A kernel's name without its return type and arguments, at most 96
    characters of letters, digits and ``_.:/<>-``."""
    name = name.replace("(anonymous namespace)", "anon").removeprefix("void ")
    cut = re.search(r"[^ (]\(", name)  # a function's arguments, not "Memcpy DtoD (...)"
    if cut:
        name = name[:cut.start() + 1]
    return re.sub(r"[^A-Za-z0-9_.:/<>-]+", "_", name).strip("_")[:96]


def _activity(e) -> str:
    """The event's kind, as newer PyTorch names it (``activity_type``);
    older releases give only the device type and whether it is a user's
    annotation, which tell the same kinds apart for this harness."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    import torch

    annotation = (e.is_user_annotation() if hasattr(e, "is_user_annotation")
                  else e.name() in (CALL, WAIT))
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "gpu_user_annotation" if annotation else "kernel"
    return "user_annotation" if annotation else "cpu_op"


def reduce(events, cards: list[int]) -> Trace:
    """The trace of the window that the harness's spans bound."""
    host, spans, ops = [], [], []
    for e in events:
        kind = _activity(e)
        if kind in DEVICE_ACTIVITIES:
            if e.device_index() in cards:
                ops.append((e.device_index(), e.name(), e.start_ns(), e.end_ns()))
        elif kind in HOST_ACTIVITIES:
            item = (e.start_ns(), e.end_ns(), e.name(), e.start_thread_id())
            if kind == "user_annotation" and e.name() in (CALL, WAIT):
                spans.append(item)
            host.append(item)
    calls = [s for s in spans if s[2] == CALL]
    if not calls:
        raise RuntimeError("the trace holds no call of the harness")
    w0 = min(s[0] for s in calls)
    w1 = max(s[1] for s in spans)
    main = calls[0][3]
    ops = [(c, n, max(t0, w0), min(t1, w1)) for c, n, t0, t1 in ops
           if t1 > w0 and t0 < w1]
    busy, gaps = {}, []
    for card in cards:
        merged = _union(sorted((t0, t1) for c, _, t0, t1 in ops if c == card))
        busy[card] = sum(t1 - t0 for t0, t1 in merged) * 1e-9
        edges = [w0] + [t for iv in merged for t in iv] + [w1]
        gaps += [(card, edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                 if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[1] - g[2])
    host = sorted(h for h in host if h[3] == main)
    labelled = [(_label(card, t0, t1, host), (t1 - t0) * 1e-9)
                for card, t0, t1 in gaps[:TOP]]
    return Trace((w1 - w0) * 1e-9, len(calls), list(cards), ops, busy, labelled)


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for t0, t1 in intervals:
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def _label(card: int, t0: int, t1: int, host: list) -> str:
    """cuda:<card>/<harness span>/<innermost host event> at the gap's middle."""
    mid = (t0 + t1) // 2
    i = bisect.bisect_right(host, (mid, float("inf")))
    span = inner = None
    for start, end, name, _ in reversed(host[:i]):
        if end < mid:
            continue
        if name in (CALL, WAIT):
            span = span or name
        else:
            inner = inner or name
        if span and inner:
            break
    span, inner = span or "outside", inner or "idle"
    return short_name(f"cuda:{card}/{span}/{inner}")


_GLOBAL = re.compile(r"__global__\b")
_NAME = re.compile(r"\s*(?:void\s+)?(\w+)\s*\(")


def kernel_names(csrc: Path, files: str = "*.cu") -> set[str]:
    """The names of the ``__global__`` functions in the program's sources:
    the kernels the port built, as they appear in the trace."""
    names = set()
    for path in sorted(csrc.glob(files)):
        text = path.read_text()
        for m in _GLOBAL.finditer(text):
            rest = text[m.end():m.end() + 400]
            rest = re.sub(r"^\s*void\s+", "", rest)
            if rest.startswith("__launch_bounds__"):
                depth, i = 0, len("__launch_bounds__")
                for i in range(i, len(rest)):
                    depth += {"(": 1, ")": -1}.get(rest[i], 0)
                    if depth == 0:
                        break
                rest = rest[i + 1:]
            found = _NAME.match(rest)
            if found:
                names.add(found.group(1))
    return names


def matcher(names: set[str]):
    """A test of a trace name for any of ``names`` as a whole word."""
    if not names:
        return lambda name: False
    pattern = re.compile(r"\b(?:" + "|".join(sorted(map(re.escape, names))) + r")\b")
    return lambda name: pattern.search(name) is not None


def port_csrc(root: Path) -> Path:
    """The port's CUDA sources in the checkout."""
    return root / "gpu_radix_sort_tpu_torch" / "csrc"
