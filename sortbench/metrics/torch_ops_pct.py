"""The share of the cards' device time in operations that are not the
port's own kernels (the ``__global__`` functions of its ``csrc/``):
PyTorch's kernels and copies around them."""

from sortbench import trace


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    port = trace.matcher(trace.kernel_names(trace.port_csrc(run.cell.root)))
    total = sum(tr.op_seconds(lambda name: True).values())
    own = sum(tr.op_seconds(port).values())
    return 100 * (total - own) / total if total > 0 else None
