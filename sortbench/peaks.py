"""Published peaks of the cards, and the bytes a sort has to move.

NVIDIA's H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s a card, at the
full power limit of 700 W (a card set lower runs slower under load; every
run prints the card's limit beside its numbers).  A sort does no
arithmetic worth a bound, so its roofline is the memory's.
"""

from __future__ import annotations

HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
KEY_BYTES = 4


def hbm_bytes_per_s(kind: str) -> float | None:
    """The published memory bandwidth of a card, or None for a card the
    table does not hold (the roofline is then not reported)."""
    return HBM_BYTES_PER_S.get(kind)


def sort_bytes(keys: int, extra_out: int = 0) -> int:
    """The least a sort of ``keys`` keys on one card moves: each key read
    once and written once, and ``extra_out`` bytes of further output."""
    return 2 * KEY_BYTES * keys + extra_out
