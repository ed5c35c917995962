"""Seeded keys, made on the device in one call a shard.

The upstream makes its keys with PCG32 (``populateInput``): uniform over
the 32 bits.  Here a ``torch.Generator`` on the shard's device draws the
same distribution; the generator's seed mixes the run's seed with the
shard's rank, so every shard of every seed is its own stream, and the same
seed gives the same keys on the same kind of device.
"""

from __future__ import annotations

import hashlib

import torch

KEY_DTYPE = torch.uint32


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for shard ``stream`` of run ``seed`` (any
    whole number, negative or beyond 64 bits included)."""
    digest = hashlib.sha256(f"sortbench:{seed}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_keys(seed: int, n: int, device, stream: int = 0) -> torch.Tensor:
    """n uint32 keys uniform over [0, 2^32) on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    x = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                      generator=g, device=device)
    return x.view(KEY_DTYPE)


def make_shards(seed: int, n: int, devices) -> list[torch.Tensor]:
    """One shard of n keys on each device, shard r from stream r."""
    return [make_keys(seed, n, d, r) for r, d in enumerate(devices)]
