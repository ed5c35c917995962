"""Device operations (kernels, copies, memsets) a call, over every card,
counted in the profiler's trace."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or not tr.calls:
        return None
    return len(tr.ops) / tr.calls
