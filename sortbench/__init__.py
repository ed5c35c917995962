"""The benchmark of gpu_radix_sort_tpu_torch, driven by data.

``python -m sortbench.run --workload <config>.<traffic> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the
cards the cell names and prints one JSON line last.  Every piece is found by
the name ``BENCHMARK.json`` gives it, so a later change adds a piece as a
new file:

  * ``configs/<config>.json``: the deployment (keys a card, cards, the
    source it comes from, the guarantees the comparison holds);
  * ``traffic/<traffic>.json``: the mix, as data: the entry it drives and
    that entry's parameters;
  * ``entries/<entry>.py``: one entry point of the port, its control and its
    comparison with ``reference.py``;
  * ``metrics/<metric>.py``: a reader that takes one metric from the run's
    timings, counters or profiler trace, or returns None where it finds
    nothing to read.

Nothing here imports jax, jaxlib or the JAX package; ``reference.py``
imports nothing of the port either.
"""
