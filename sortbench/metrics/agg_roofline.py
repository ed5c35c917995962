"""The aggregate's share of its memory roofline on the busiest card: the
least time the card's published bandwidth allows for a call (each row read
once, each group's key and count written once: the entry's
``bytes_per_card``), over the card's device busy time a call (every kernel
and copy, whoever wrote it)."""

from sortbench import peaks


def read(run):
    tr = run.trace
    bw = peaks.hbm_bytes_per_s(run.kind)
    if tr is None or not tr.calls or bw is None:
        return None
    busy = max(tr.busy_s.values(), default=0.0) / tr.calls
    return 100 * run.bytes_per_card / bw / busy if busy > 0 else None
