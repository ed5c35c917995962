"""The traced window put down to the port's own spans.

    python3 -m sortbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as ``python3 -m sortbench.run ... --trace 1`` does and prints
its result line, then one more line, ``{"spans": ...}``: the same profiler
events reduced by the port's ``grs.*`` spans (``utils/timers.span`` in
``gpu_radix_sort_tpu_torch``), which ride the profiler's clock:

  * each device operation is linked by its correlation id to the runtime
    call that launched it, or else to the PyTorch op around that launch,
    and put down to the innermost ``grs.*`` span around the launch on the
    harness's thread (``None`` where none is, or where the event carries no
    correlation id);
  * the host's blocking runtime calls (``cuda*Synchronize``, ``cudaMemcpy``)
    outside the harness's ``sortbench.wait``, put down the same way;
  * the longest idle gaps of the cards, labelled
    ``cuda:<card>/<harness span>/<grs span>/<host event>``, the ``grs``
    segment left out where no span encloses the gap's middle;
  * four figures a call: ``host_wait_ms`` (the blocking calls inside
    ``grs.*`` spans), and the device ms, on the card that spends most, of
    the operations launched in ``grs.binning.stage_a`` (``stage_a_ms``), in
    ``grs.exchange`` (``exchange_step_ms``) and in ``grs.round`` itself
    (``round_ops_ms``).  Each is None where the trace holds no program span,
    or nothing in that span.

The benchmark's own runs do not reduce by span: ``trace.reduce`` keeps no
host event and no correlation id for the metric readers.
"""

from __future__ import annotations

import contextlib
import json
import re
import sys
from dataclasses import dataclass, field

from . import trace

PREFIX = "grs."
BLOCKING = re.compile(r"^cu(?:da)?\w*Synchronize$|^cudaMemcpy$")
# a CUDA API call (``cuda*``, ``cu*``): its own kind, or by name where the
# release tells only host and device events apart (``trace._activity``)
RUNTIME = re.compile(r"^cu(?:da)?[A-Z]")


@dataclass
class Split:
    calls: int
    cards: list[int]
    device_s: dict[tuple[str | None, int], float]  # (innermost span, card) -> seconds
    host_wait_s: dict[str | None, float]  # innermost span -> blocking host seconds
    spans: dict[str, int] = field(default_factory=dict)  # span -> times opened
    gaps: list[tuple[str, float]] = field(default_factory=list)  # the longest, labelled

    def card_seconds(self, select) -> dict[int, float]:
        """Device seconds of the operations whose span ``select`` accepts,
        by card."""
        out = {c: 0.0 for c in self.cards}
        for (name, card), s in self.device_s.items():
            if select(name):
                out[card] += s
        return out

    def span_ms(self, name: str) -> float | None:
        """Device ms a call of the operations launched in ``name`` itself,
        on the card that spends most on them."""
        if not self.spans or not self.calls:
            return None
        worst = max(self.card_seconds(lambda n: n == name).values(), default=0.0)
        return 1e3 * worst / self.calls if worst > 0 else None

    def host_wait_ms(self) -> float | None:
        if not self.spans or not self.calls:
            return None
        return 1e3 * sum(s for n, s in self.host_wait_s.items() if n) / self.calls

    def attributed_pct(self) -> float | None:
        """The share of the busiest card's device time launched inside a
        program span."""
        total = self.card_seconds(lambda n: True)
        if not total or max(total.values()) <= 0:
            return None
        card = max(total, key=total.get)
        inside = self.card_seconds(lambda n: n is not None)[card]
        return 100 * inside / total[card]

    def report(self) -> dict:
        per_call = 1e3 / max(self.calls, 1)
        device: dict[str, dict[int, float]] = {}
        for (name, card), s in sorted(self.device_s.items(), key=lambda kv: -kv[1]):
            device.setdefault(str(name), {})[card] = s * per_call
        return {
            "calls": self.calls,
            "host_wait_ms": self.host_wait_ms(),
            "stage_a_ms": self.span_ms("grs.binning.stage_a"),
            "exchange_step_ms": self.span_ms("grs.exchange"),
            "round_ops_ms": self.span_ms("grs.round"),
            "attributed_pct": self.attributed_pct(),
            "spans_per_call": {n: k / max(self.calls, 1) for n, k in sorted(self.spans.items())},
            "device_ms_per_call": device,
            "host_wait_ms_per_call": {str(n): s * per_call for n, s in
                                      sorted(self.host_wait_s.items(), key=lambda kv: -kv[1])},
            "idle_gaps": [list(g) for g in self.gaps],
        }


def _kind(e) -> str:
    """``trace._activity``, with a ``grs.*`` span an annotation on releases
    that only tell annotations by the harness's own names."""
    kind = trace._activity(e)
    if e.name().startswith(PREFIX) and kind in ("kernel", "cpu_op"):
        return "gpu_user_annotation" if kind == "kernel" else "user_annotation"
    return kind


def _id(e, what: str) -> int:
    get = getattr(e, what, None)
    return get() if get is not None else 0


def innermost(spans: list[tuple[int, int, str]], times: list[int]) -> list[str | None]:
    """The name of the innermost span around each time, None where none is:
    ``spans`` are (start, end, name), nested, from one thread."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out: list[str | None] = [None] * len(times)
    stack: list[tuple[int, int, str]] = []
    i = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[q] = stack[-1][2] if stack else None
    return out


def split(events, cards: list[int]) -> Split:
    """The window's device time, host waits and idle gaps by span."""
    harness, spans, host, ops = [], [], [], []
    launched: dict[int, int] = {}  # correlation id -> the launch's start
    torch_ops: dict[int, int] = {}  # a PyTorch op's correlation id -> its start
    for e in events:
        kind = _kind(e)
        if kind in trace.DEVICE_ACTIVITIES:
            if e.device_index() in cards:
                ops.append((e.device_index(), e.start_ns(), e.end_ns(),
                            _id(e, "correlation_id"), _id(e, "linked_correlation_id")))
            continue
        if kind not in trace.HOST_ACTIVITIES:
            continue
        name = e.name()
        item = (e.start_ns(), e.end_ns(), name, e.start_thread_id())
        if kind == "user_annotation" and name in (trace.CALL, trace.WAIT):
            harness.append(item)
        elif kind == "user_annotation" and name.startswith(PREFIX):
            spans.append(item)
        else:
            host.append(item)
            corr = _id(e, "correlation_id")  # the runtime's ids and PyTorch's apart
            if corr and (kind in ("cuda_runtime", "cuda_driver") or RUNTIME.match(name)):
                launched[corr] = e.start_ns()
            elif corr and kind == "cpu_op":
                torch_ops[corr] = e.start_ns()
    calls = [s for s in harness if s[2] == trace.CALL]
    if not calls:
        raise RuntimeError("the trace holds no call of the harness")
    w0 = min(s[0] for s in calls)
    w1 = max(s[1] for s in harness)
    main = calls[0][3]
    spans = [(t0, t1, n) for t0, t1, n, th in spans if th == main and t1 > w0 and t0 < w1]
    host = sorted(h for h in host if h[3] == main)
    ops = [(c, max(t0, w0), min(t1, w1), corr, linked) for c, t0, t1, corr, linked in ops
           if t1 > w0 and t0 < w1]

    at = [launched[corr] if corr in launched else torch_ops.get(linked)
          for _, _, _, corr, linked in ops]
    known = [i for i, t in enumerate(at) if t is not None]
    names = innermost(spans, [at[i] for i in known])
    owner: list[str | None] = [None] * len(ops)
    for i, name in zip(known, names):
        owner[i] = name
    device: dict[tuple[str | None, int], float] = {}
    for (card, t0, t1, _, _), name in zip(ops, owner):
        device[name, card] = device.get((name, card), 0.0) + (t1 - t0) * 1e-9

    waits = [h for h in host if BLOCKING.match(h[2]) and w0 <= h[0] < w1]
    waits = [h for h, where in zip(waits, innermost(
        [(t0, t1, n) for t0, t1, n, _ in harness], [h[0] for h in waits]))
        if where != trace.WAIT]
    host_wait: dict[str | None, float] = {}
    for (t0, t1, _, _), name in zip(waits, innermost(spans, [h[0] for h in waits])):
        host_wait[name] = host_wait.get(name, 0.0) + (t1 - t0) * 1e-9

    opened: dict[str, int] = {}
    for _, _, name in spans:
        opened[name] = opened.get(name, 0) + 1
    return Split(len(calls), list(cards), device, host_wait, opened,
                 _gaps(ops, cards, w0, w1, harness, spans, host))


def _gaps(ops, cards, w0, w1, harness, spans, host) -> list[tuple[str, float]]:
    """The longest idle gaps of the cards, labelled as ``trace._label``
    labels them, with the innermost ``grs.*`` span at the gap's middle
    inserted after the harness's span."""
    gaps = []
    for card in cards:
        merged = trace._union(sorted((t0, t1) for c, t0, t1, _, _ in ops if c == card))
        edges = [w0] + [t for iv in merged for t in iv] + [w1]
        gaps += [(card, edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                 if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[1] - g[2])
    gaps = gaps[:trace.TOP]
    host = sorted(harness + host)
    steps = innermost(spans, [(t0 + t1) // 2 for _, t0, t1 in gaps])
    out = []
    for (card, t0, t1), step in zip(gaps, steps):
        label = trace._label(card, t0, t1, host)
        if step:
            card_part, where, inner = label.split("/", 2)
            label = trace.short_name(f"{card_part}/{where}/{step}/{inner}")
        out.append((label, (t1 - t0) * 1e-9))
    return out


@contextlib.contextmanager
def splitting():
    """Within it, each ``trace.reduce`` also puts the same events down to
    spans; yields the list their reports are appended to."""
    found: list[dict] = []
    reduce = trace.reduce

    def reduce_and_split(events, cards):
        events = list(events)
        found.append(split(events, cards).report())
        return reduce(events, cards)

    trace.reduce = reduce_and_split
    try:
        yield found
    finally:
        trace.reduce = reduce


def main(argv=None) -> int:
    from . import run

    argv = list(sys.argv[1:] if argv is None else argv)
    with splitting() as found:
        rc = run.main([*argv, "--trace", "1"])
    if rc == 0 and not found:
        raise RuntimeError("the traced run never called trace.reduce: no spans to report")
    if found:
        print(json.dumps({"spans": found[0]}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
