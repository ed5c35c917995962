"""The port's native host library (gpu_radix_sort_tpu_torch/utils/native.py,
native/sortcore.cpp) against the JAX package's and numpy: the PCG32 fill of
``Pcg32.fill``, the CPU oracle sorts, the histogram; the range checks; where
the library is built and loaded from, and that a failed build raises."""

import threading
from pathlib import Path

import numpy as np
import pytest

from gpu_radix_sort_tpu.utils import keygen as jkeygen
from gpu_radix_sort_tpu.utils import native as jnative
from gpu_radix_sort_tpu_torch.utils import keygen, native

PKG = Path(keygen.__file__).resolve().parent.parent
TRACKED_SO = Path(jnative._SO_PATH).resolve()


def _keys(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    keys[::5] &= np.uint32(0xFF00FF0F)  # duplicate digits in every window
    keys[:2] = np.array([0, 0xFFFFFFFF], np.uint32)[:n]
    return keys


def test_fill_matches_jax_and_the_plain_fill_across_calls():
    """The stream continues across calls of every size, the threaded fill's
    (>= 2^20 words) included, with the same state after each call."""
    port, plain, ref = keygen.Pcg32(), keygen.Pcg32(), jkeygen.Pcg32()
    for n in (0, 1, 7, 1 << 16, (1 << 20) + 3):
        got = port.fill(n)
        assert got.dtype == np.uint32 and got.shape == (n,)
        np.testing.assert_array_equal(got, ref.fill(n))
        np.testing.assert_array_equal(got, plain.fill_plain(n))
        assert port.state == ref.state == plain.state


def test_fill_matches_the_direct_loop():
    for state in (keygen.PCG32_INIT_STATE, 0, 0xFFFFFFFFFFFFFFFF, 12345):
        a, b, c = keygen.Pcg32(state), keygen.Pcg32(state), keygen.Pcg32(state)
        for n in (0, 3, 1000):
            want = c.fill_reference_loop(n)
            np.testing.assert_array_equal(a.fill(n), want)
            np.testing.assert_array_equal(b.fill_plain(n), want)
            assert a.state == b.state == c.state


def test_fill_rejects_negative_n():
    for fill in (keygen.Pcg32().fill, keygen.Pcg32().fill_plain):
        with pytest.raises(ValueError):
            fill(-1)


@pytest.mark.parametrize("n", [0, 1, 1000, 1 << 16])
def test_cpu_sort_matches_numpy(n):
    keys = _keys(n)
    got = native.cpu_sort(keys)
    np.testing.assert_array_equal(got, np.sort(keys))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(keys, _keys(n))  # a copy; the input unchanged


@pytest.mark.parametrize("offset,width", [(0, 4), (3, 5), (24, 8), (16, 16)])
def test_cpu_partial_matches_jax(offset, width):
    keys = _keys(5000, seed=offset + width)
    got_keys, got_bounds = native.cpu_partial(keys, offset, width)
    want_keys, want_bounds = jnative.cpu_partial(keys, offset, width)
    assert got_keys.dtype == np.uint32 and got_bounds.dtype == np.uint32
    np.testing.assert_array_equal(got_keys, want_keys)
    np.testing.assert_array_equal(got_bounds, want_bounds)


@pytest.mark.parametrize("offset,width", [(0, 1), (0, 8), (7, 9), (28, 4), (16, 16)])
def test_histogram_matches_bincount(offset, width):
    keys = _keys(5000, seed=width)
    digits = (keys >> np.uint32(offset)) & np.uint32((1 << width) - 1)
    got = native.histogram(keys, offset, width)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, np.bincount(digits, minlength=1 << width))


@pytest.mark.parametrize("offset,width", [(30, 8), (32, 1), (0, 33), (0, 0), (-1, 4),
                                          (0xFFFFFFFE, 4)])
def test_bad_ranges_raise(offset, width):
    keys = np.arange(10, dtype=np.uint32)
    with pytest.raises(ValueError):
        native.histogram(keys, offset, width)
    with pytest.raises(ValueError):
        native.cpu_partial(keys, offset, width)


def test_library_is_built_from_the_ports_source_into_build():
    lib = Path(native.load()._name).resolve()
    assert lib.parent == PKG / "_build"
    assert lib == native.library_path().resolve()
    assert lib != TRACKED_SO and lib.parent != TRACKED_SO.parent
    assert native.SOURCE == PKG / "native" / "sortcore.cpp"


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="compiler"):
        native.load()
    with pytest.raises(RuntimeError):
        keygen.Pcg32().fill(4)
    assert not list((tmp_path / "build").glob("*.so"))


def test_failed_compile_raises_with_its_stderr(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native.load()
    assert not list((tmp_path / "build").iterdir())  # no temporary left


def test_two_threads_build_at_first_use(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    results, errors = [None, None], []

    def first_use(i):
        try:
            results[i] = keygen.Pcg32().fill(1000)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    np.testing.assert_array_equal(results[0], results[1])
    np.testing.assert_array_equal(results[0], keygen.Pcg32().fill_plain(1000))
    assert [p.name for p in (tmp_path / "build").iterdir()] == [native.library_path().name]
