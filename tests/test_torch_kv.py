"""Key-value sorts of the PyTorch port vs the JAX package: sort_key_value,
every payload form of sort_key_value_by_digits, and the (n, L)-matrix
binning pass (binning_pass_kv, sort_key_value_by_digits_large).  Same
inputs to both sides, made from a seed; outputs must be equal bytes.

The JAX functions here run XLA sorts on the CPU, no Pallas kernel.  B5
tiles are cut to SMALL_TILE keys so that each binning pass runs many tiles;
keys carry many duplicates so that stability shows.  Payloads the JAX
package cannot hold without 64-bit mode (int64, float64) are held against
numpy's stable argsort instead."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_radix_sort_tpu_torch as port
from gpu_radix_sort_tpu.ops import radix_sort as jrs
from gpu_radix_sort_tpu.utils.keygen import Pcg32, generate_payloads
from gpu_radix_sort_tpu_torch.ops import binning as bn
from gpu_radix_sort_tpu_torch.ops import radix_sort as rs

torch.set_num_threads(1)

N = 3000
SMALL_TILE = 256


@pytest.fixture(autouse=True)
def small_tiles(monkeypatch):
    """Many B5 tiles, and wide payload rows gathered in many chunks."""
    monkeypatch.setattr(bn, "TILE", SMALL_TILE)
    monkeypatch.setattr(rs, "GATHER_CHUNK", 256)


def _payload(form: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(len(form))
    return {
        "u32": lambda: np.arange(n, dtype=np.uint32),
        "i32": lambda: rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
        "f32": lambda: rng.standard_normal(n).astype(np.float32),
        "u16": lambda: np.arange(n, dtype=np.uint16),
        "u8": lambda: (np.arange(n) % 251).astype(np.uint8),
        "i64": lambda: rng.integers(-(1 << 62), 1 << 62, n),
        "f64": lambda: rng.standard_normal(n),
        "lanes2": lambda: np.stack([np.arange(n, dtype=np.uint32), Pcg32(7).fill(n)], 1),
        "lanes6": lambda: Pcg32(9).fill(6 * n).reshape(n, 6),
        "rows8": lambda: generate_payloads(n, payload_bytes=8),
        "rows64": lambda: generate_payloads(n, payload_bytes=64),
        "rows7": lambda: generate_payloads(n, payload_bytes=7),
        "i16x3x2": lambda: (np.arange(6 * n) % 30011).astype(np.int16).reshape(n, 3, 2),
        "empty": lambda: np.zeros((n, 0), np.uint8),
        # a (n, 1) view: torch.from_numpy gives its last axis stride 0
        "col1": lambda: np.arange(n, dtype=np.uint32)[:, None],
    }[form]()


PAYLOADS = ["u32", "i32", "f32", "u16", "u8", "i64", "f64", "lanes2", "lanes6",
            "rows8", "rows64", "rows7", "i16x3x2", "empty", "col1"]
NO_X64 = ("i64", "f64")  # JAX without 64-bit mode turns these into 4-byte types


def _dup_keys(n: int, state: int = 11) -> np.ndarray:
    return Pcg32(state=state).fill(n) & np.uint32(0xF0F)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got: torch.Tensor, want: np.ndarray) -> None:
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("form", PAYLOADS)
def test_sort_key_value_payloads_match_jax(form):
    keys, values = _dup_keys(N), _payload(form, N)
    if form in NO_X64:
        order = np.argsort(keys, kind="stable")
        want_k, want_v = keys[order], values[order]
    else:
        want_k, want_v = map(np.asarray, jrs.sort_key_value(jnp.asarray(keys), jnp.asarray(values)))
    for strategy in (None, "torch"):
        got_k, got_v = port.sort_key_value(_t(keys), _t(values), strategy=strategy)
        _same(got_k, want_k)
        _same(got_v, want_v)


WINDOWS = [(4, 8), (0, 4), (8, 8), (5, 11), (0, 32), (28, 4), (3, 1)]


@pytest.mark.parametrize("i,form", list(enumerate(PAYLOADS)))
def test_sort_key_value_by_digits_payloads_match_jax(i, form):
    offset, width = WINDOWS[i % len(WINDOWS)]
    keys, values = Pcg32(state=i).fill(N), _payload(form, N)
    keys[::3] &= np.uint32(0xFFF000FF)  # duplicate digits in every window
    if form in NO_X64:
        digits = (keys.astype(np.uint64) >> np.uint64(offset)) & np.uint64((1 << width) - 1)
        order = np.argsort(digits, kind="stable")
        want_k, want_v = keys[order], values[order]
    else:
        want_k, want_v = map(np.asarray, jrs.sort_key_value_by_digits(
            jnp.asarray(keys), jnp.asarray(values), offset, width))
    for strategy in (None, "torch"):
        got_k, got_v = port.sort_key_value_by_digits(
            _t(keys), _t(values), offset, width, strategy=strategy)
        _same(got_k, want_k)
        _same(got_v, want_v)


def _typed_keys(dtype: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(2)
    if dtype == "int32":
        keys = rng.integers(-50, 50, n).astype(np.int32)
        keys[:3] = [np.iinfo(np.int32).min, 0, np.iinfo(np.int32).max]
        return keys
    raw = rng.integers(0, 1 << 32, 40, dtype=np.uint32)  # 40 values, many repeats
    raw[:6] = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00001, 0xFFC00000]
    return raw[rng.integers(0, 40, n)].view(np.float32)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("form", ["u32", "lanes6"])
def test_sort_key_value_typed_keys_match_jax(dtype, form):
    keys, values = _typed_keys(dtype, N), _payload(form, N)
    want_k, want_v = map(np.asarray, jrs.sort_key_value(jnp.asarray(keys), jnp.asarray(values)))
    for strategy in (None, "torch"):
        got_k, got_v = port.sort_key_value(_t(keys), _t(values), strategy=strategy)
        assert got_k.dtype == getattr(torch, dtype)
        _same(got_k, want_k)
        _same(got_v, want_v)


@pytest.mark.parametrize("n", [0, 1, SMALL_TILE + 1])
def test_sort_key_value_small_n_matches_jax(n):
    """At n = 0 the JAX package's wide-payload route fails (a reshape of 0
    rows), so the numpy stable oracle stands in there."""
    keys = _dup_keys(n, state=n)
    order = np.argsort(keys, kind="stable")
    for form in ("u32", "rows8"):
        values = _payload(form, n)
        want_k, want_v = keys[order], values[order]
        if n:
            want_k, want_v = map(np.asarray, jrs.sort_key_value(jnp.asarray(keys), jnp.asarray(values)))
        got_k, got_v = port.sort_key_value(_t(keys), _t(values))
        _same(got_k, want_k)
        _same(got_v, want_v)


@pytest.mark.parametrize("offset,width,L", [(0, 4, 1), (28, 4, 3), (5, 3, 2), (8, 8, 5)])
def test_binning_pass_kv_matches_jax(offset, width, L):
    keys = _dup_keys(N, state=L)
    lanes = Pcg32(state=100 + L).fill(N * L).reshape(N, L)
    want_k, want_l = map(np.asarray, jrs.sort_key_value_by_digits(
        jnp.asarray(keys), jnp.asarray(lanes), offset, width, strategy="xla"))
    got_k, got_l = bn.binning_pass_kv(_t(keys), _t(lanes), offset, width, tile=128)
    _same(got_k, want_k)
    _same(got_l, want_l)


@pytest.mark.parametrize("offset,width,L", [(0, 16, 2), (3, 13, 5)])
def test_sort_key_value_by_digits_large_matrix_matches_jax(offset, width, L):
    keys = _dup_keys(N, state=width)
    lanes = Pcg32(state=200 + L).fill(N * L).reshape(N, L)
    want_k, want_l = map(np.asarray, jrs.sort_key_value_by_digits(
        jnp.asarray(keys), jnp.asarray(lanes), offset, width, strategy="xla"))
    got_k, got_l = bn.sort_key_value_by_digits_large(_t(keys), _t(lanes), offset, width, tile=128)
    _same(got_k, want_k)
    _same(got_l, want_l)
    got_k, got_cols = bn.sort_key_value_by_digits_large(
        _t(keys), tuple(_t(lanes[:, w]) for w in range(L)), offset, width, tile=128)
    _same(got_k, want_k)
    _same(torch.stack(got_cols, dim=1), want_l)


def test_kv_sorts_reject_bad_input():
    keys = _t(_dup_keys(100))
    with pytest.raises(ValueError, match="leading axis"):
        port.sort_key_value(keys, torch.zeros(99, 3, dtype=torch.uint8))
    with pytest.raises(ValueError, match="leading axis"):
        port.sort_key_value_by_digits(keys, torch.tensor(5), 0, 4)
    with pytest.raises(TypeError, match="uint32/int32/float32"):
        port.sort_key_value(keys.to(torch.int64), torch.zeros(100))
    with pytest.raises(ValueError, match="digit range"):
        port.sort_key_value_by_digits(keys, torch.zeros(100), 30, 4)
    with pytest.raises(ValueError, match=r"\(n, L\)"):
        bn.binning_pass_kv(keys, torch.zeros(100, dtype=torch.uint32), 0, 4)


def test_new_entry_points_never_sort_host_input_on_the_cpu(monkeypatch):
    """A numpy array goes to the CUDA device; with none, the entry points of
    the key-value, 64-bit and table paths raise instead of sorting on the
    CPU."""
    from gpu_radix_sort_tpu_torch.ops import table

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys, k64 = Pcg32().fill(100), np.arange(100, dtype=np.uint64)
    vals = np.arange(100, dtype=np.uint32)
    calls = [
        lambda: port.sort_key_value(keys, vals),
        lambda: port.sort_key_value(_t(keys), vals),
        lambda: port.sort_key_value_by_digits(keys, np.zeros((100, 8), np.uint8), 0, 8),
        lambda: port.sort_full_u64(k64),
        lambda: port.sort_key_value_u64(k64, vals),
        lambda: port.sort_partial_u64(k64, 0, 8),
        lambda: port.sort_partial_counts_u64(k64, 0, 8, stable=False),
        lambda: table.hash_u32(keys),
        lambda: table.partition_by_ids(keys, vals % 4, 4),
        lambda: table.filter_range(keys, 0, 1 << 31),
        lambda: table.compact(keys, keys > 5),
        lambda: table.group_aggregate(keys, None, "count"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="pass a CPU torch.Tensor"):
            call()
