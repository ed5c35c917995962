"""Zipf(alpha) rows made on the card from the harness's uniform keys.

The rows follow Gray et al., "Quickly Generating Billion-Record Synthetic
Databases" (SIGMOD 1994): a row's rank is the Zipf distribution's inverse
CDF at a uniform number, and the rank is spread over the 32-bit keys by the
Fibonacci hash that the port's ``utils/keygen.generate_zipf_keys`` applies
to numpy's ``rng.zipf`` ranks, so that hot keys fall across the radix
digits and duplicates stay duplicates.

A row's uniform number is its key in the harness's shard (``keys.py``: 32
uniform bits w), u = (w + 1/2) / 2^32, so the rows are made on the shard's
device from it, with no host generation and no copy from the host.  A
rank k <= ``EXACT`` comes from the exact float64 CDF, P(k) = k^-alpha /
zeta(alpha); the tail beyond, of mass T = 1 - CDF(EXACT), from the
continuous (Pareto) inverse x = (EXACT + 1/2) (q / T)^(-1 / (alpha - 1)),
q = 1 - u, rounded to the nearest rank and clamped to [EXACT + 1,
``MAX_RANK``].  The same shard gives the same rows on the same kind of
device.

:func:`expected_groups` is this maker's own expected number of distinct
ranks among n rows.  Two ranks can hash to one key; at 256Mi rows of
Zipf(1.2) that merges ~0.1% of the groups, which it does not subtract.

Nothing here imports the port.
"""

from __future__ import annotations

import torch

EXACT = 1 << 20  # ranks drawn from the exact CDF
MAX_RANK = 1 << 62
FIB = 11400714819323198485  # 2^64 / the golden ratio, odd (keygen.generate_zipf_keys)
CHUNK = 1 << 24  # rows made at a time, so that the float64 steps stay small
_MASK32 = 0xFFFFFFFF
_TWO32 = float(1 << 32)


def cdf(alpha: float) -> tuple[torch.Tensor, float]:
    """(P(rank <= k) for k = 1 ... EXACT as float64 on the CPU, the tail's
    mass T).  zeta(alpha) is the exact head plus the Euler-Maclaurin sum of
    the rest, sum_{k > K} k^-a = K^(1-a)/(a-1) - K^-a/2 + a K^(-a-1)/12."""
    if not alpha > 1:
        raise ValueError(f"Zipf needs alpha > 1, got {alpha}")
    k = torch.arange(1, EXACT + 1, dtype=torch.float64)
    head = torch.cumsum(k.pow(-alpha), 0)
    K = float(EXACT)
    rest = K ** (1 - alpha) / (alpha - 1) - K ** -alpha / 2 + alpha * K ** (-alpha - 1) / 12
    c = head / (head[-1] + rest)
    return c, 1.0 - float(c[-1])


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32) and m < 2^32, in 16-bit
    halves so that no int64 product overflows."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _MASK32


def fib_hash(rank: torch.Tensor) -> torch.Tensor:
    """Bits 32 ... 63 of (rank * FIB) mod 2^64, as int64 in [0, 2^32), for
    int64 ranks in [0, 2^62): numpy's ``(ranks * FIB) >> 32`` in uint64,
    in 16- and 32-bit pieces so that no int64 product overflows."""
    f0, f1 = FIB & _MASK32, FIB >> 32
    r0, r1 = rank & _MASK32, rank >> 32
    a, b = r0 >> 16, r0 & 0xFFFF
    carry = (a * f0 + ((b * f0) >> 16)) >> 16  # floor(r0 * f0 / 2^32)
    return (carry + _mul32(r0, f1) + _mul32(r1, f0)) & _MASK32


def ranks(words: torch.Tensor, table: torch.Tensor, tail: float, alpha: float) -> torch.Tensor:
    """The Zipf rank (int64) of each uniform 32-bit word (int64 in [0,
    2^32)), ``table`` and ``tail`` from :func:`cdf` on the words' device."""
    u = (words.to(torch.float64) + 0.5) / _TWO32
    head = torch.searchsorted(table, u, right=True) + 1
    q = ((_TWO32 - 0.5) - words.to(torch.float64)) / _TWO32  # 1 - u, exactly
    x = (EXACT + 0.5) * (q / tail).pow(-1.0 / (alpha - 1))
    far = torch.floor(x + 0.5).clamp(max=MAX_RANK).to(torch.int64).clamp(min=EXACT + 1)
    return torch.where(head > EXACT, far, head)


def rows(shard: torch.Tensor, alpha: float) -> torch.Tensor:
    """uint32 Zipf(alpha) keys, one for each uniform uint32 key of
    ``shard``, on its device."""
    table, tail = cdf(alpha)
    table = table.to(shard.device)
    words = shard.view(torch.int32)
    out = torch.empty_like(words)
    for lo in range(0, words.numel(), CHUNK):
        w = words[lo:lo + CHUNK].to(torch.int64) & _MASK32
        key = fib_hash(ranks(w, table, tail, alpha))
        out[lo:lo + CHUNK] = (key - ((key >> 31) << 32)).to(torch.int32)
    return out.view(torch.uint32)


def expected_groups(n: int, alpha: float) -> float:
    """The expected number of distinct ranks among n rows: the sum over
    ranks of 1 - (1 - c / 2^32)^n, c the words that give the rank.

    Head ranks take the words below their CDF bounds.  A tail word j = 2^32
    - 1 - w (q = (j + 1/2) / 2^32) has a rank of at least r where j + 1/2
    <= Q(r) = 2^32 T ((EXACT + 1/2) / (r - 1/2))^(alpha - 1), which counts
    the words of each tail rank up to the rank from which every word has a
    rank of its own (where -dQ/dr falls to 1); beyond it each word counts
    once, but for those clamped together at MAX_RANK."""
    table, tail = cdf(alpha)

    def present(c: torch.Tensor) -> torch.Tensor:
        return -torch.expm1(n * torch.log1p(-c / _TWO32))

    bounds = torch.ceil(table * _TWO32 - 0.5)  # words with u below each bound
    total = float(present(torch.diff(bounds, prepend=bounds.new_zeros(1))).sum())
    words = _TWO32 - float(bounds[-1])
    scale = _TWO32 * tail * (EXACT + 0.5) ** (alpha - 1)

    def at_least(r: torch.Tensor) -> torch.Tensor:
        q = scale * (r - 0.5).pow(-(alpha - 1))
        return torch.where(r <= EXACT + 1, words, torch.floor(q + 0.5).clamp(0, words))

    own = min(int(((alpha - 1) * scale) ** (1 / alpha) + 0.5) + 2, MAX_RANK)
    if own - EXACT > 1 << 27:
        raise ValueError(f"alpha {alpha} is too near 1 for the count rank by rank")
    for lo in range(EXACT + 1, own, CHUNK >> 2):
        r = torch.arange(lo, min(lo + (CHUNK >> 2), own) + 1, dtype=torch.float64)
        g = at_least(r)
        total += float(present(g[:-1] - g[1:]).sum())
    one = torch.ones((), dtype=torch.float64)
    spread, clamped = (float(at_least(torch.tensor(float(r), dtype=torch.float64)))
                       for r in (own, MAX_RANK))
    return total + (spread - clamped) * float(present(one)) + float(present(one * clamped))
