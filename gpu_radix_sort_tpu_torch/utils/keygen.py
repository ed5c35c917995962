"""Deterministic key generation, bit-exact with the reference generator.

Port of ``gpu_radix_sort_tpu/utils/keygen.py`` (numpy only): the reference
fills input arrays with a PCG32 (XSH-RR) stream from a fixed initial state
(libsort/utils.cu:63-79, ``populateInput``), whose state persists across
calls in a process.  The same PCG32 state gives the same words here as in
the JAX package, so both packages sort the same keys.

The fill is vectorized with LCG jump-ahead: the state recurrence
``s' = s*A + C (mod 2^64)`` admits closed-form doubling.

:func:`generate_zipf_keys` and :func:`generate_payloads` (skewed keys and
row payloads for the key-value and aggregate paths) draw from numpy's
``default_rng`` by seed, so they give the JAX package's bytes.
"""

from __future__ import annotations

import numpy as np

# PCG32 constants (reference: libsort/utils.cu:67-69)
PCG32_INIT_STATE = np.uint64(0x4D595DF4D0F33173)
_MULT = np.uint64(6364136223846793005)
_INC = np.uint64(1442695040888963407)
_U64_1 = np.uint64(1)


def _fill_states(state0: np.uint64, n: int) -> np.ndarray:
    """States s_0..s_{n-1} of the LCG starting at ``state0`` (given the
    first m states, the next m are ``s[m:2m] = s[:m]*A^m + C_m``)."""
    states = np.empty(n, dtype=np.uint64)
    if n == 0:
        return states
    states[0] = state0
    m = 1
    a, c = _MULT, _INC  # advance-by-m coefficients, m=1
    with np.errstate(over="ignore"):
        while m < n:
            take = min(m, n - m)
            states[m : m + take] = states[:take] * a + c
            a, c = a * a, c * (a + _U64_1)
            m *= 2
    return states


def _pcg32_output(states: np.ndarray) -> np.ndarray:
    """XSH-RR output function applied elementwise to raw LCG states
    (reference: libsort/utils.cu:65,72-77)."""
    with np.errstate(over="ignore"):
        count = (states >> np.uint64(59)).astype(np.uint32)
        x = states ^ (states >> np.uint64(18))
        x32 = ((x >> np.uint64(27)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        neg = (np.uint32(32) - count) & np.uint32(31)
        return (x32 >> count) | np.where(count == 0, np.uint32(0), x32 << neg)


class Pcg32:
    """Explicit-state PCG32 XSH-RR generator, bit-exact with the reference:
    output is computed from the pre-advance state, which then advances by
    ``s*A + C``."""

    def __init__(self, state: int | np.uint64 = PCG32_INIT_STATE):
        self.state = np.uint64(state)

    def fill(self, n: int) -> np.ndarray:
        """Next ``n`` uint32 words of the stream (advances state by n)."""
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        states = _fill_states(self.state, n)
        if n:
            with np.errstate(over="ignore"):
                self.state = states[-1] * _MULT + _INC
        return _pcg32_output(states)


# Process-global stream, mirroring the reference's C `static` state
# (libsort/utils.cu:67): repeated generate_keys() calls continue one stream.
_GLOBAL = Pcg32()


def generate_keys(n: int) -> np.ndarray:
    """``populateInput`` equivalent: next n uint32 keys of the process-global
    reference stream."""
    return _GLOBAL.fill(n)


def reset_global_stream() -> None:
    """Rewind the process-global stream to the reference's initial state."""
    _GLOBAL.state = PCG32_INIT_STATE


def generate_zipf_keys(
    n: int, *, alpha: float = 1.1, universe: int = 2**32, seed: int = 0
) -> np.ndarray:
    """Skewed uint32 keys: Zipf-distributed ranks spread over the key
    universe by a multiplicative (Fibonacci) hash, so hot keys land across
    the radix space while duplicates stay duplicates."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(alpha, size=n).astype(np.uint64)
    mixed = (ranks * np.uint64(11400714819323198485)) >> np.uint64(64 - 32)
    return (mixed % np.uint64(universe)).astype(np.uint32)


def generate_payloads(n: int, *, payload_bytes: int = 64, seed: int = 1) -> np.ndarray:
    """Row payloads for key-value sorts: (n, payload_bytes) uint8, made from
    ``seed`` independently of the key stream."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, payload_bytes), dtype=np.uint8)
