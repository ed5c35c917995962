"""Device ms a call of every other device operation, PyTorch's kernels,
copies and memsets, on the card that spends most on them: in the
aggregate, the hash and its inverse, both combines, the packs, the
binning passes' stage A and the exchange's windows."""

from sortbench import trace


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or not tr.calls:
        return None
    port = trace.matcher(trace.kernel_names(trace.port_csrc(run.cell.root)))
    worst = max(tr.op_seconds(lambda name: not port(name)).values(), default=0.0)
    return 1e3 * worst / tr.calls if worst > 0 else None
