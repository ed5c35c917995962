"""PyTorch port's merge levels and large sort (the port of B2) vs the JAX
package's Pallas merge in interpret mode, at the small geometry
tests/test_pallas_merge.py uses.  On a CPU tensor the port runs the
kernel's plain version; csrc/merge_path.cu itself is checked against that
plain version on the card by chip_smoke.py.  Outputs must be equal bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu.ops import pallas_merge as pm
from gpu_radix_sort_tpu.utils.keygen import Pcg32
from gpu_radix_sort_tpu_torch.ops import merge_sort as ms

TILE, B_OUT = 2048, 512  # the JAX tests' small geometry


def _alternating_runs(keys: np.ndarray, L: int) -> np.ndarray:
    """Sorted runs of length L (the last may be short), odd runs reversed:
    the merge level's input convention."""
    runs = [np.sort(keys[s:s + L]) for s in range(0, keys.size, L)]
    return np.concatenate(
        [r[::-1] if i % 2 else r for i, r in enumerate(runs)] or [keys]
    )


@pytest.mark.parametrize("nruns", [2, 4])
def test_merge_level_matches_pallas(nruns):
    keys = Pcg32(state=nruns).fill(nruns * TILE)
    n = keys.size
    x = _alternating_runs(keys, TILE)
    headroom = np.zeros(pm._pad_rows(B_OUT) * 128, np.uint32)
    want = np.asarray(
        pm.merge_level(
            jnp.asarray(np.concatenate([x, headroom]).reshape(-1, 128)),
            TILE, B_OUT, n=n,
        )
    ).reshape(-1)[:n]
    got = ms.merge_level(torch.from_numpy(x), TILE)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "n,L", [(5 * 300 + 7, 300), (3 * 1024, 1024), (1000, 4096), (7, 1), (0, 8)]
)
def test_merge_level_short_last_run(n, L):
    """Pairs of runs come out as runs of 2L, ascending iff the pair index
    is even; a short last pair or a lone last run keeps that rule."""
    keys = Pcg32(state=n + L).fill(n)
    got = ms.merge_level(torch.from_numpy(_alternating_runs(keys, L)), L)
    np.testing.assert_array_equal(got.numpy(), _alternating_runs(keys, 2 * L))


def test_merge_level_rejects_bad_run_length():
    with pytest.raises(ValueError, match="run length"):
        ms.merge_level(torch.zeros(8, dtype=torch.uint32), 0)
    with pytest.raises(TypeError, match="uint32"):
        ms.merge_level(torch.zeros(8, dtype=torch.int64), 4)


@pytest.mark.parametrize(
    "maker",
    [
        lambda rng: Pcg32(state=5).fill(3000),
        lambda rng: rng.integers(0, 4, size=3500).astype(np.uint32),
        lambda rng: np.concatenate(
            [np.full(1000, 7, np.uint32), np.full(1000, 0xFFFFFFFF, np.uint32),
             Pcg32(state=6).fill(501)]
        ),
        lambda rng: np.sort(Pcg32(state=7).fill(4096))[::-1].copy(),
    ],
    ids=["non-pow2", "dup-heavy", "with-max-keys", "reversed"],
)
def test_sort_full_large_matches_pallas(maker):
    keys = maker(np.random.default_rng(0))
    want = np.asarray(pm.sort_full_large(jnp.asarray(keys), tile=TILE, b_out=B_OUT))
    got = ms.sort_full_large(torch.from_numpy(keys), tile=TILE)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))
