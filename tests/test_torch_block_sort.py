"""PyTorch port's tile sort (block_sort, the port of B1) and one-block sort
(single_block, the port of B3) vs the JAX package's Pallas kernels in
interpret mode, at the small geometry tests/test_pallas_merge.py uses.  On a
CPU tensor the port runs the kernels' plain versions; csrc/block_sort.cu
itself is checked against them on the card by chip_smoke.py.  Outputs must
be equal bytes."""

import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu.ops import pallas_merge as pm
from gpu_radix_sort_tpu.ops import pallas_sort
from gpu_radix_sort_tpu.utils.keygen import Pcg32
from gpu_radix_sort_tpu_torch.kernels import build
from gpu_radix_sort_tpu_torch.ops import block_sort as bs
from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
from gpu_radix_sort_tpu_torch.ops import single_block as sb

TILE = 2048  # the JAX tests' small geometry


@pytest.mark.parametrize("alternate", [False, True])
def test_sort_tiles_matches_pallas(alternate):
    keys = Pcg32(state=11).fill(4 * TILE)
    want = np.asarray(
        pm.sort_tiles(jnp.asarray(keys).reshape(-1, 128), TILE, alternate=alternate)
    ).reshape(-1)
    got = ms.sort_tiles(torch.from_numpy(keys), TILE, alternate=alternate)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "maker",
    [
        lambda: Pcg32(state=1).fill(1),
        lambda: Pcg32(state=2).fill(1000),
        lambda: Pcg32(state=3).fill(4099),
        lambda: np.array([0xFFFFFFFF, 0, 5, 5, 5, 0xFFFFFFFF, 0, 1] * 200, np.uint32),
        lambda: np.full(1024, 0xFFFFFFFF, np.uint32),
    ],
    ids=["n1", "n1000", "n4099", "dups-and-max", "all-max"],
)
def test_single_block_matches_pallas_sort_full(maker):
    keys = maker()
    want = np.asarray(pallas_sort.sort_full(jnp.asarray(keys)))
    got = sb.sort_single_block(torch.from_numpy(keys))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 77, 3 * 256 + 77, 4 * 256])
@pytest.mark.parametrize("alternate", [False, True])
def test_block_sort_short_last_tile(n, alternate):
    """The last tile may be short; it keeps its tile's direction."""
    tile = 256
    keys = Pcg32(state=n).fill(n)
    want = []
    for t, start in enumerate(range(0, n, tile)):
        run = np.sort(keys[start:start + tile])
        want.append(run[::-1] if alternate and t % 2 else run)
    want = np.concatenate(want) if want else keys
    got = bs.block_sort(torch.from_numpy(keys), tile, alternate=alternate)
    np.testing.assert_array_equal(got.numpy(), want)


def test_block_sort_rejects_what_the_kernel_does_not_take():
    x = torch.from_numpy(Pcg32().fill(64))
    for tile in (0, 3, 2 * bs.TILE):
        with pytest.raises(ValueError, match="tile must be a power of two"):
            bs.block_sort(x, tile)
    with pytest.raises(TypeError, match="uint32"):
        bs.block_sort(x.view(torch.int32))
    with pytest.raises(TypeError, match="1-D contiguous"):
        bs.block_sort(x.view(8, 8))
    with pytest.raises(TypeError, match="1-D contiguous"):
        bs.block_sort(x[::2])
    with pytest.raises(ValueError, match="neither on the CPU nor on CUDA"):
        bs.block_sort(torch.empty(64, dtype=torch.uint32, device="meta"))
    with pytest.raises(ValueError, match="one block sorts at most"):
        sb.sort_single_block(torch.zeros(bs.TILE + 1, dtype=torch.uint32))


def test_cpu_tensors_launch_nothing():
    before = (bs.launches, ms.launches, sb.launches)
    x = torch.from_numpy(Pcg32().fill(3 * TILE))
    ms.sort_full_large(x, tile=TILE)
    sb.sort_single_block(x[:TILE])
    assert (bs.launches, ms.launches, sb.launches) == before


def test_c_entry_points_match_the_ctypes_signatures():
    """The ctypes argtypes must list as many arguments as the C entry point
    takes: a pointer passed without c_void_p would be cut to 32 bits."""
    sources = "".join(p.read_text() for p in build._sources())
    assert {p.name for p in build._sources()} == {
        "binning.cu", "block_sort.cu", "exchange.cu", "merge_path.cu"}
    for name, argtypes in build._SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", sources)
        assert m, name
        params = [p for p in m.group(1).split(",") if p.strip()]
        assert len(params) == len(argtypes), name
        for param, argtype in zip(params, argtypes):
            is_pointer = "*" in param or "cudaStream_t" in param
            assert is_pointer == (argtype is build.ctypes.c_void_p), (name, param)
    assert "-gencode" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def _fake_nvcc(path, *, fail_on=""):
    """A stand-in for nvcc that writes its -o target (or fails on a source
    whose name contains ``fail_on``)."""
    path.write_text(
        "#!/bin/sh\n"
        f'case "$*" in *{fail_on or "@never@"}*) echo "error in $*" >&2; exit 2;; esac\n'
        'while [ $# -gt 0 ]; do if [ "$1" = -o ]; then echo built > "$2"; fi; shift; done\n'
    )
    path.chmod(0o755)
    return str(path)


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """One nvcc -c a source, then one link; the objects go away."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_nvcc", lambda: _fake_nvcc(tmp_path / "nvcc"))
    lib = build.build()
    assert lib == build.library_path() and lib.read_text() == "built\n"
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == [lib.name]
    assert build.build() == lib  # built already: nothing runs


@pytest.mark.parametrize("edited", ["bitonic.cuh", "block_rank.cuh", "register_bitonic.cuh", "exchange.cu"])
def test_library_name_hashes_sources_and_shared_headers(tmp_path, monkeypatch, edited):
    """An edit to a shared header builds anew, as an edit to a source does."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert "bitonic.cuh" in {p.name for p in build._headers()}
    before = build.library_path()
    assert build.library_path() == before
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    assert build.library_path() != before


def test_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_nvcc", lambda: _fake_nvcc(tmp_path / "nvcc", fail_on="binning.cu"))
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*error in"):
        build.build()
    assert list((tmp_path / "_build").iterdir()) == []
