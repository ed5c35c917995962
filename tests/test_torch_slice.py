"""Slices one and two of the PyTorch port as a whole vs the JAX package:
sort_full (uint32, int32, float32), the stable and unstable sort_partial,
sort_partial_counts, sort_key_value_by_digits (the key-value, 64-bit and
table paths in test_torch_kv/u64/table.py), compute_boundaries,
digit_counts, counts_to_boundaries, routing, the pipelines and the CLI;
plus the rules that host input never sorts on the CPU and that the port
imports neither jax nor the JAX package.  Same inputs to both sides;
outputs must be equal bytes."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_radix_sort_tpu_torch as port
from gpu_radix_sort_tpu.cli import main as jax_cli
from gpu_radix_sort_tpu.models.pipelines import FullSortPipeline as JaxFullSortPipeline
from gpu_radix_sort_tpu.models.pipelines import (
    PartialSortPipeline as JaxPartialSortPipeline,
)
from gpu_radix_sort_tpu.ops import boundaries as jbounds
from gpu_radix_sort_tpu.ops import radix_sort as jrs
from gpu_radix_sort_tpu.utils.keygen import Pcg32
from gpu_radix_sort_tpu_torch.cli import main as port_cli
from gpu_radix_sort_tpu_torch.ops import binning as bn
from gpu_radix_sort_tpu_torch.ops import block_sort as bs
from gpu_radix_sort_tpu_torch.ops import boundaries, radix_sort
from gpu_radix_sort_tpu_torch.ops import digit_sort as ds
from gpu_radix_sort_tpu_torch.utils import checks, timers

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


@pytest.mark.parametrize(
    "n", [0, 1, 5000, ds.MAX_N_KV, ds.MAX_N_KV + 1, bn.TILE + 1, 40000]
)
@pytest.mark.parametrize("offset,width", [(3, 1), (0, 4), (8, 8), (16, 16), (5, 11)])
def test_sort_partial_stable_matches_jax(n, offset, width):
    keys = Pcg32(state=n + width).fill(n)
    keys[::4] &= np.uint32(0xFFFF00FF)  # duplicate digits: stability shows
    want_s, want_b = jrs.sort_partial(jnp.asarray(keys), offset, width)
    got_s, got_b = port.sort_partial(torch.from_numpy(keys), offset, width)
    assert got_s.dtype == torch.uint32 and got_b.dtype == torch.uint32
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    want_s, want_c = jrs.sort_partial_counts(jnp.asarray(keys), offset, width)
    got_s, got_c = port.sort_partial_counts(torch.from_numpy(keys), offset, width)
    assert got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    got_t, _ = port.sort_partial(torch.from_numpy(keys), offset, width, strategy="torch")
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32"])
@pytest.mark.parametrize("n", [1, 5000, 40000])
@pytest.mark.parametrize("strategy", [None, "torch"])
def test_sort_key_value_by_digits_matches_jax(dtype, n, strategy):
    keys = Pcg32(state=n).fill(n)
    values = np.arange(n, dtype=np.uint32).view(dtype)
    want_k, want_v = jrs.sort_key_value_by_digits(
        jnp.asarray(keys), jnp.asarray(values), 8, 4
    )
    got_k, got_v = port.sort_key_value_by_digits(
        torch.from_numpy(keys), torch.from_numpy(values), 8, 4, strategy=strategy
    )
    assert got_v.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy().view(np.uint32),
                                  np.asarray(want_v).view(np.uint32))


def test_wide_kv_payloads_wait_for_roadmap_a4():
    """Payloads other than one 4-byte column, which ROADMAP A2 brought: (n, 2)
    int32 lanes and an int64 column sort like the JAX package's (the int64
    one against numpy, as JAX holds no int64 without 64-bit mode); a payload
    whose leading axis is not n raises.  Every form: test_torch_kv.py."""
    keys = Pcg32().fill(100)
    lanes = np.arange(200, dtype=np.int32).reshape(100, 2)
    want_k, want_v = jrs.sort_key_value_by_digits(jnp.asarray(keys), jnp.asarray(lanes), 0, 4)
    got_k, got_v = port.sort_key_value_by_digits(torch.from_numpy(keys), torch.from_numpy(lanes), 0, 4)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    wide = np.arange(100, dtype=np.int64) << 40
    _, got_v = port.sort_key_value_by_digits(torch.from_numpy(keys), torch.from_numpy(wide), 0, 4)
    np.testing.assert_array_equal(got_v.numpy(), wide[np.argsort(keys & 15, kind="stable")])
    with pytest.raises(ValueError, match="leading axis"):
        port.sort_key_value_by_digits(torch.from_numpy(keys), torch.zeros(99, dtype=torch.int32), 0, 4)


def test_digit_counts_and_counts_to_boundaries_match_jax():
    keys = Pcg32(state=5).fill(20000)
    keys[:3000] = 0x00000A00
    for offset, width in [(8, 4), (0, 1), (16, 16)]:
        want = np.asarray(jbounds.digit_counts(jnp.asarray(keys), offset, width))
        got = port.digit_counts(torch.from_numpy(keys), offset, width)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            port.counts_to_boundaries(got).numpy(),
            np.asarray(jbounds.counts_to_boundaries(jnp.asarray(want))),
        )
        np.testing.assert_array_equal(got.numpy(), checks.true_bucket_counts(keys, offset, width))


def test_digit_range_is_validated():
    keys = torch.from_numpy(Pcg32().fill(100))
    for stable in (True, False):
        with pytest.raises(ValueError, match="digit range"):
            port.sort_by_digits(keys, 30, 4, stable=stable)
    with pytest.raises(ValueError, match="digit range"):
        port.sort_partial_counts(keys, 0, 0)
    with pytest.raises(TypeError, match="1-D uint32"):
        port.sort_partial(keys.view(torch.int32), 0, 4)


def test_host_input_never_sorts_on_the_cpu(monkeypatch):
    """A numpy array goes to the CUDA device; where there is none, every
    entry point raises instead of quietly sorting on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = Pcg32().fill(100)
    calls = [
        lambda: port.sort_full(keys),
        lambda: port.sort_by_digits(keys, 0, 8),
        lambda: port.sort_partial(keys, 0, 8),
        lambda: port.sort_partial(keys, 0, 8, stable=False),
        lambda: port.sort_partial_counts(keys, 0, 8),
        lambda: port.sort_key_value_by_digits(keys, np.arange(100, dtype=np.uint32), 0, 8),
        lambda: port.sort_key_value_by_digits(
            torch.from_numpy(keys), np.arange(100, dtype=np.uint32), 0, 8),
        lambda: port.compute_boundaries(np.sort(keys), 0, 8),
        lambda: port.digit_counts(keys, 0, 8),
        lambda: port.counts_to_boundaries(np.ones(4, np.int32)),
        lambda: port.extract_digits(keys, 0, 8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="pass a CPU torch.Tensor"):
            call()


def test_routes_and_strategies():
    assert radix_sort._resolve(None, 1) == "single_block"
    assert radix_sort._resolve("auto", bs.TILE) == "single_block"
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
    assert radix_sort._resolve(None, ds.MAX_N_KV, "kv", 8) == "digit_sort"
    assert radix_sort._resolve(None, ds.MAX_N_KV + 1, "kv", 8) == "binning"
    assert radix_sort._resolve("torch", 10, "kv", 8) == "torch"


def test_full_sort_pipeline_matches_jax():
    fn, (example,) = port.FullSortPipeline(n=3000, device="cpu").build()
    jfn, (jexample,) = JaxFullSortPipeline(n=3000).build()
    np.testing.assert_array_equal(example.numpy(), np.asarray(jexample))
    np.testing.assert_array_equal(fn(example).numpy(), np.asarray(jfn(jexample)))


def test_partial_sort_pipeline_matches_jax():
    fn, (example,) = port.PartialSortPipeline(n=3000, offset=4, width=8, device="cpu").build()
    jfn, (jexample,) = JaxPartialSortPipeline(n=3000, offset=4, width=8).build()
    np.testing.assert_array_equal(example.numpy(), np.asarray(jexample))
    for got, want in zip(fn(example), jfn(jexample)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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
    # the sample sort (one CPU rank) writes the JAX package's file (its
    # sample sort over the 8 CPU devices)
    port_out, jax_out = tmp_path / "port_sample.bin", tmp_path / "jax_sample.bin"
    assert port_cli(["sort", "--in", str(port_keys), "--mode", "sample", "--device", "cpu",
                     "--verify", "--out", str(port_out)]) == 0
    assert "EXACT MATCH" in capsys.readouterr().err
    assert jax_cli(["sort", "--in", str(jax_keys), "--mode", "sample",
                    "--out", str(jax_out)]) == 0
    assert port_out.read_bytes() == jax_out.read_bytes()


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
    checked = {path.relative_to(REPO).as_posix() for path in files}
    assert {f"gpu_radix_sort_tpu_torch/{m}" for m in (
        "ops/table.py", "ops/radix_sort.py", "ops/bits.py", "ops/binning.py",
        "utils/keygen.py", "utils/timers.py", "utils/config.py", "data/__init__.py",
        "data/interface.py", "data/helpers.py", "data/mem.py", "data/file.py",
        "data/device.py", "parallel/bucket_reader.py", "parallel/storage_sort.py",
        "parallel/serverless.py", "parallel/worker_main.py",
        "parallel/sample_sort.py", "parallel/pipeline.py", "bench/harness.py",
        "bench/analyze.py", "utils/native.py", "parallel/multihost.py",
        "parallel/peer_memory.py", "dryrun.py")} <= checked
    for path in files:
        for module in _imported_modules(path):
            top = module.split(".")[0]
            assert top not in ("jax", "jaxlib", "gpu_radix_sort_tpu"), (path, module)
