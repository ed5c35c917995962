"""The entries a traffic mix can drive, one module each, found by name.

An entry module gives:

  * ``program(cell, devices)``: the timed call, a function of the run's
    inputs (one uint32 shard on each device), built once at set-up;
  * ``control(cell, devices)``: the same call one step below the stated
    guarantees, which the comparison has to fail;
  * ``compare(cell, seed, devices, outputs)``: ``{name: (value, limit)}``
    of the kept outputs against ``reference.py`` on keys made again;
  * ``keys_per_call(cell, devices)`` and ``bytes_per_card(cell)``: the keys
    a call sorts, and the least bytes it moves on one card.
"""
