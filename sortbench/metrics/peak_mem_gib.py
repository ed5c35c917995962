"""The fullest card's peak of allocated memory during a call, in GiB: the
keys and every buffer of the sort, without the outputs that the harness
keeps for its check (``torch.cuda.max_memory_allocated``)."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
