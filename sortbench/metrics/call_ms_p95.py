"""The 95th percentile of the window's calls, each from its start to its
end on every card (CUDA events on the cards' streams, the slowest card)."""

from sortbench.stats import percentile


def read(run):
    return percentile(run.call_ms, 95) if run.call_ms else None
