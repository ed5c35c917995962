"""The mesh sort's tail: the 95th percentile of the traced window's calls,
each from its start to its end on every card (CUDA events on the cards'
streams; the slowest card sets it).  A window of the four-card cell holds
too few calls for an end-to-end tail, so this one has no bound."""

from sortbench.stats import percentile


def read(run):
    return percentile(run.call_ms, 95) if run.call_ms else None
