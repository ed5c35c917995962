"""Device ms a call of the port's own kernels (the ``__global__`` functions
of its ``csrc/``) on the card that spends most on them: in the aggregate,
the onesweep sort of the hashes and the binning passes (B5) of the final
key-value sort."""

from sortbench import trace


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or not tr.calls:
        return None
    port = trace.matcher(trace.kernel_names(trace.port_csrc(run.cell.root)))
    worst = max(tr.op_seconds(port).values(), default=0.0)
    return 1e3 * worst / tr.calls if worst > 0 else None
