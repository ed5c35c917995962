"""Seconds from the process's start to the window's: imports, the cards'
contexts, the keys, the entry's set-up and the warm-up calls (on a
checkout's first run, the nvcc build of the port's kernels)."""


def read(run):
    return run.setup_s
