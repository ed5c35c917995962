"""The share of the traced window in which the busiest card runs no
kernel and no copy."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.busy_s:
        return None
    return 100 * (1 - max(tr.busy_s.values()) / tr.window_s)
