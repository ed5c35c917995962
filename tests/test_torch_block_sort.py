"""PyTorch port's tile sort (block_sort, the port of B1) and one-block sort
(single_block, the port of B3) vs the JAX package's Pallas kernels in
interpret mode, at the small geometry tests/test_pallas_merge.py uses.  On a
CPU tensor the port runs the kernels' plain versions; csrc/block_sort.cu
itself is checked against them on the card by chip_smoke.py.  The tile
pass's register network (block_sort.windowed_network_emulated: 2^14-slot
blocks of 32 keys a thread, phases 1..log2(tile), round trips through
shared memory into windows, pads by final direction) is emulated in torch
and held against numpy, the plain version and JAX, as is B3's network
(tile_network_emulated, every lane stride by shuffles) at the JAX tiles.
Outputs must be equal bytes."""

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


@pytest.fixture
def one_torch_thread():
    """One intra-op thread a worker: the emulation's many small ops run
    tens of times slower with a pool thread a core in each of the suite's
    worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiles_numpy(keys: np.ndarray, tile: int, alternate: bool) -> np.ndarray:
    """Each tile sorted by numpy, odd tiles reversed under ``alternate``."""
    runs = [np.sort(keys[s:s + tile]) for s in range(0, keys.size, tile)]
    return np.concatenate(
        [r[::-1] if alternate and i % 2 else r for i, r in enumerate(runs)] or [keys])


NETWORKS = {"windowed": bs.windowed_network_emulated, "shuffles": bs.tile_network_emulated}


def _tile_keys(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return Pcg32(state=seed).fill(n)
    if kind == "duplicate":  # both ends of the range: ties with either pad
        return np.array([0, 3, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)[rng.integers(0, 4, n)]
    return np.full(n, 0xFFFFFFFF if kind == "all-max" else 0, np.uint32)


@pytest.mark.parametrize("tile", [1, 2, 128, 512, 2048])
@pytest.mark.parametrize("alternate", [False, True])
@pytest.mark.parametrize("last", ["even", "odd"])
def test_tile_network_emulated_ragged_last_tile(tile, alternate, last, one_torch_thread):
    """n = k * tile + r with k even or odd: the short last tile keeps its
    parity's direction and its pads (0 where it descends) are never
    returned; two blocks of 2^14 slots where the tiles allow."""
    k = (2 if last == "even" else 3) * max(1, 8192 // tile)
    n = k * tile + max(1, tile // 3)
    for kind in ("random", "duplicate"):
        keys = _tile_keys(kind, n, n + tile)
        got = bs.windowed_network_emulated(torch.from_numpy(keys), tile, alternate=alternate)
        np.testing.assert_array_equal(got.numpy(), _tiles_numpy(keys, tile, alternate))
        np.testing.assert_array_equal(
            got.numpy(), bs.block_sort_plain(torch.from_numpy(keys), tile,
                                             alternate=alternate).numpy())


@pytest.mark.parametrize("kind", ["all-max", "all-zero"])
@pytest.mark.parametrize("tile", [2, 512, 1024, bs.TILE])
def test_tile_network_emulated_constant_keys(kind, tile, one_torch_thread):
    """Keys equal to the ascending pad (all-max) or to the descending pad
    (all-zero), with a ragged odd last tile."""
    n = 3 * tile + 1
    keys = _tile_keys(kind, n, 0)
    got = bs.windowed_network_emulated(torch.from_numpy(keys), tile, alternate=True)
    np.testing.assert_array_equal(got.numpy(), keys)


@pytest.mark.parametrize("network", list(NETWORKS))
@pytest.mark.parametrize("alternate", [False, True])
def test_tile_network_emulated_matches_pallas(network, alternate, one_torch_thread):
    keys = Pcg32(state=12).fill(4 * TILE)
    want = np.asarray(
        pm.sort_tiles(jnp.asarray(keys).reshape(-1, 128), TILE, alternate=alternate)
    ).reshape(-1)
    got = NETWORKS[network](torch.from_numpy(keys), TILE, alternate=alternate)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tile", [64, 128, 1024, 2048, bs.TILE])
@pytest.mark.parametrize("last", ["even", "odd"])
def test_windowed_network_at_full_tiles(tile, last, one_torch_thread):
    """Tiles of 2^7 and up take the round trips (two windows a phase, three
    from 2^11): duplicate keys at both ends of the range, a ragged last
    tile, two or three blocks."""
    n = (4 if last == "even" else 5) * bs.TILE // (bs.TILE // tile) + 4321 % tile
    keys = _tile_keys("duplicate", n, tile)
    got = bs.windowed_network_emulated(torch.from_numpy(keys), tile, alternate=True)
    np.testing.assert_array_equal(got.numpy(), _tiles_numpy(keys, tile, True))


def test_window_plan_covers_every_stride_once():
    """Each phase runs its strides p-1..0 once each, in order, every stride
    inside the window it runs in (or a lane stride of window 0); phases of
    2^7 and up make 2 or 3 round trips and end in window 0: 20 round trips
    and one shuffle stage at 2^14 keys."""
    trips = shuffles = 0
    for p in range(1, bs.TILE_LOG + 1):
        window, strides = 0, []
        for step, v in bs.window_plan(p):
            if step == "window":
                window, trips = v, trips + 1
                continue
            strides.append(v)
            if not window <= v < window + 5:
                assert window == 0 and 5 <= v < 10
                shuffles += 1
        assert strides == list(range(p - 1, -1, -1)) and window == 0
    assert (trips, shuffles) == (20, 1)


@pytest.mark.parametrize("k", range(bs.TILE_LOG - 5 + 1))
def test_window_words_are_a_conflict_free_permutation(k):
    """Window k's words are the padded words of every slot once, the word
    of register r is the thread's base word plus a constant, and the 32
    lanes of a warp hit 32 different banks for every register."""
    threads = 1 << (bs.TILE_LOG - 5)
    words = bs.window_words(k, threads)
    assert sorted(words.reshape(-1).tolist()) == [bs.padded_word(s) for s in range(bs.TILE)]
    offsets = words - words[:, :1]
    assert bool((offsets == offsets[0]).all())
    banks = (words % 32).view(threads // 32, 32, 32)
    assert bool((banks.sort(dim=1).values == torch.arange(32)[:, None]).all())


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
        "binning.cu", "block_sort.cu", "exchange.cu", "merge_path.cu", "onesweep.cu"}
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


@pytest.mark.parametrize("edited", ["merge_path.cu", "block_rank.cuh", "register_bitonic.cuh", "exchange.cu"])
def test_library_name_hashes_sources_and_shared_headers(tmp_path, monkeypatch, edited):
    """An edit to a shared header builds anew, as an edit to a source does."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert {p.name for p in build._headers()} == {"block_rank.cuh", "register_bitonic.cuh"}
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
