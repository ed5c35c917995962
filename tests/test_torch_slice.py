"""Slice one of the PyTorch port as a whole vs the JAX package: sort_full
(uint32, int32, float32), sort_partial(stable=False), compute_boundaries,
routing, the pipeline and the CLI; plus the rule that the port imports
neither jax nor the JAX package.  Same inputs to both sides; outputs must
be equal bytes."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_radix_sort_tpu_torch as port
from gpu_radix_sort_tpu.cli import main as jax_cli
from gpu_radix_sort_tpu.models.pipelines import FullSortPipeline as JaxFullSortPipeline
from gpu_radix_sort_tpu.ops import boundaries as jbounds
from gpu_radix_sort_tpu.ops import radix_sort as jrs
from gpu_radix_sort_tpu.utils.keygen import Pcg32
from gpu_radix_sort_tpu_torch.cli import main as port_cli
from gpu_radix_sort_tpu_torch.ops import block_sort as bs
from gpu_radix_sort_tpu_torch.ops import boundaries, radix_sort
from gpu_radix_sort_tpu_torch.utils import timers

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n", [0, 1, 5000, bs.TILE, bs.TILE + 1, 40000])
def test_sort_full_matches_jax(n):
    keys = Pcg32(state=n + 3).fill(n)
    keys[: n // 7] = 0xFFFFFFFF
    want = np.asarray(jrs.sort_full(jnp.asarray(keys)))
    got = port.sort_full(torch.from_numpy(keys))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        port.sort_full(torch.from_numpy(keys), strategy="torch").numpy(), want
    )


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("n", [3000, bs.TILE + 100])
def test_sort_full_typed_keys_match_jax(dtype, n):
    raw = Pcg32(state=n).fill(n)
    raw[:6] = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00001, 0xFFC00000]
    keys = raw.view(dtype)
    want = np.asarray(jrs.sort_full(jnp.asarray(keys)))
    got = port.sort_full(torch.from_numpy(keys)).numpy()
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("offset,width", [(8, 8), (0, 4), (28, 4), (0, 32), (5, 11)])
def test_sort_partial_unstable_matches_jax(offset, width):
    keys = Pcg32(state=offset + width).fill(bs.TILE + 999)
    if width == 32:  # 2^32 boundaries would take tens of GB: sorted keys only
        want = jrs.sort_by_digits(jnp.asarray(keys), offset, width, stable=False)
        got = port.sort_by_digits(torch.from_numpy(keys), offset, width, stable=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    want_s, want_b = jrs.sort_partial(jnp.asarray(keys), offset, width, stable=False)
    got_s, got_b = port.sort_partial(torch.from_numpy(keys), offset, width, stable=False)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_b.dtype == torch.uint32
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


@pytest.mark.parametrize(
    "digits",
    [
        [0, 0, 1, 3, 3, 7],   # groups 0 and 1 present
        [2, 2, 5, 6, 6, 6],   # first digit >= 2: groups [2, d0] backfilled
        [0, 0, 3, 3, 3, 15],  # empty group 1 reports 0
        [15, 15, 15],         # one group, the last
        [],                   # no keys
    ],
)
def test_compute_boundaries_matches_jax(digits):
    offset, width = 4, 4
    keys = (np.array(digits, np.uint32) << np.uint32(offset)) | np.uint32(9)
    want = np.asarray(jbounds.compute_boundaries(jnp.asarray(keys), offset, width))
    got = boundaries.compute_boundaries(torch.from_numpy(keys), offset, width)
    np.testing.assert_array_equal(got.numpy(), want)
    if keys.size:
        np.testing.assert_array_equal(
            boundaries.true_group_starts(torch.from_numpy(keys), offset, width).numpy(),
            np.asarray(jbounds.true_group_starts(jnp.asarray(keys), offset, width)),
        )


def test_stable_digit_sorts_are_not_ported_yet():
    keys = torch.from_numpy(Pcg32().fill(100))
    with pytest.raises(NotImplementedError, match="B4/B5"):
        port.sort_partial(keys, 0, 8)
    with pytest.raises(NotImplementedError, match="B4/B5"):
        port.sort_by_digits(keys, 0, 8, stable=True)
    with pytest.raises(ValueError, match="digit range"):
        port.sort_by_digits(keys, 30, 4, stable=False)


def test_routes_and_strategies():
    assert radix_sort._resolve(None, 1) == "block_sort"
    assert radix_sort._resolve("auto", bs.TILE) == "block_sort"
    assert radix_sort._resolve("auto", bs.TILE + 1) == "merge"
    assert radix_sort._resolve("torch", 1 << 26) == "torch"
    with pytest.raises(ValueError, match="strategy must be one of"):
        radix_sort._resolve("xla", 10)
    with pytest.raises(ValueError, match="strategy must be one of"):
        port.set_default_strategy("pallas")
    assert port.get_default_strategy() == "auto"
    port.set_default_strategy("torch")
    try:
        assert radix_sort._resolve(None, 1 << 26) == "torch"
    finally:
        port.set_default_strategy("auto")
    with pytest.raises(TypeError, match="unsupported key dtype"):
        port.sort_full(torch.zeros(4, dtype=torch.int64))


def test_full_sort_pipeline_matches_jax():
    fn, (example,) = port.FullSortPipeline(n=3000, device="cpu").build()
    jfn, (jexample,) = JaxFullSortPipeline(n=3000).build()
    np.testing.assert_array_equal(example.numpy(), np.asarray(jexample))
    np.testing.assert_array_equal(fn(example).numpy(), np.asarray(jfn(jexample)))


def test_cli_gen_and_sort_match_jax_file_format(tmp_path, capsys):
    port_keys, jax_keys = tmp_path / "port.bin", tmp_path / "jax.bin"
    out = tmp_path / "sorted.bin"
    assert port_cli(["gen", "--n", "20000", "--out", str(port_keys)]) == 0
    assert jax_cli(["gen", "--n", "20000", "--out", str(jax_keys)]) == 0
    assert port_keys.read_bytes() == jax_keys.read_bytes()
    assert port_cli(["sort", "--in", str(port_keys), "--mode", "single",
                     "--device", "cpu", "--verify", "--out", str(out)]) == 0
    assert "EXACT MATCH" in capsys.readouterr().err
    keys = np.fromfile(port_keys, dtype=np.uint32)
    np.testing.assert_array_equal(np.fromfile(out, dtype=np.uint32), np.sort(keys))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port_cli(["sort", "--mode", "mesh", "--n", "10", "--device", "cpu"])


def test_wall_timer_takes_the_median():
    calls = []
    ms = timers.time_wall(lambda: calls.append(1), warmup=2, iters=3)
    assert len(calls) == 5
    assert 0.0 <= ms < 1e3


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "gpu_radix_sort_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for module in _imported_modules(path):
            top = module.split(".")[0]
            assert top not in ("jax", "jaxlib", "gpu_radix_sort_tpu"), (path, module)
