"""The mean host time from a call's start to its return, before the
synchronise that ends it: what the port's host code takes to enqueue a
call (host clock; the profiler's own cost is in it in a traced run)."""


def read(run):
    if not run.enqueue_ms:
        return None
    return sum(run.enqueue_ms) / len(run.enqueue_ms)
