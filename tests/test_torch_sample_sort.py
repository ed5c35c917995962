"""The mesh sample sort (PSRS) of the PyTorch port vs the JAX package's
``parallel/sample_sort.py``: the 32-bit, key-value, 64-bit and 64-bit
key-value forms, their build functions and host entry points, both reassemblies,
and ``merge_presorted``.  The same numpy-seeded input goes through JAX's
mesh of the first P of its 8 CPU devices and the port's ``[cpu] * P``.

The build functions are compared rank by rank: the valid counts, the overflow
count and the valid prefix of every rank's buffer, byte for byte (what lies
past a rank's count is not part of the contract).  The host entry points
are compared whole, and where they overflow they must fall back or raise
where JAX's do.  The port's ``reassembly="merge"`` is held against JAX's
``"sort"``, which gives the same bytes: JAX's "merge" runs a Pallas kernel,
and no test here runs a JAX Pallas kernel in interpret mode (the JAX sides
are XLA sorts on the CPU).  Where JAX itself fails on an input, the port is
held against numpy.

B5's tile is cut so that the key-value sorts' binning passes run many
tiles, and the JAX build functions are cached by shape, so that its compiles stay
few."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from gpu_radix_sort_tpu.ops.bits import encode_ordered_np64
from gpu_radix_sort_tpu.parallel import distributed as jdist
from gpu_radix_sort_tpu.parallel import key_mesh as jax_key_mesh
from gpu_radix_sort_tpu.parallel import sample_sort as js
from gpu_radix_sort_tpu.utils.keygen import Pcg32, generate_payloads, generate_zipf_keys
from gpu_radix_sort_tpu_torch.ops import binning as bn
from gpu_radix_sort_tpu_torch.ops import merge_sort as ms
from gpu_radix_sort_tpu_torch.parallel import mesh as pm
from gpu_radix_sort_tpu_torch.parallel import sample_sort as ss
from gpu_radix_sort_tpu_torch.parallel.distributed import OverflowError_

RANKS = (1, 3, 8)
SIZES = (0, 1, 64, 1111, 4099)
SMALL_TILE = 256


@pytest.fixture(autouse=True)
def _small_geometry(monkeypatch):
    """One intra-op thread (the suite runs in several processes), and B5
    tiles of SMALL_TILE keys."""
    monkeypatch.setattr(bn, "TILE", SMALL_TILE)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_mesh(P: int):
    return jax_key_mesh(jax.devices("cpu")[:P])


def _cpu_mesh(P: int):
    return pm.key_mesh([torch.device("cpu")] * P)


@functools.lru_cache(maxsize=None)
def _jax_fn(kind: str, P: int, n_local: int, factor: float, lanes: int = 0):
    mesh = _jax_mesh(P)
    if kind == "keys":
        return js.build_sample_sort(mesh, n_local, capacity_factor=factor)
    if kind == "kv":
        return js.build_sample_sort_kv(mesh, n_local, lanes, capacity_factor=factor)
    if kind == "64":
        return js.build_sample_sort_64(mesh, n_local, capacity_factor=factor)
    return js.build_sample_sort_kv64(mesh, n_local, lanes, capacity_factor=factor)


def _n_local(n: int, P: int) -> int:
    return max(-(-n // P), P)


def _padded(a: np.ndarray, P: int, fill) -> np.ndarray:
    """``a`` padded with ``fill`` rows to the mesh, as the host wrappers pad."""
    n_pad = _n_local(a.shape[0], P) * P
    out = np.full((n_pad, *a.shape[1:]), fill, a.dtype)
    out[:a.shape[0]] = a
    return out


def _jax_put(a: np.ndarray, P: int):
    return jax.device_put(a, NamedSharding(_jax_mesh(P), PartitionSpec("x")))


def _port_put(a: np.ndarray, P: int) -> list:
    n_local = a.shape[0] // P
    return [torch.from_numpy(a[r * n_local:(r + 1) * n_local].copy()) for r in range(P)]


def _same_ranks(P, got_counts, got_arrays, jax_counts, jax_arrays, overflow, jax_overflow):
    """The same overflow count; if none, the same valid counts, and each
    rank's valid prefix of every array equal byte for byte."""
    assert int(overflow) == int(jax_overflow)
    if int(jax_overflow):
        return
    counts = np.asarray(jax_counts).reshape(-1)
    np.testing.assert_array_equal(pm.unshard(got_counts).numpy(), counts)
    for got, want in zip(got_arrays, jax_arrays):
        want = np.asarray(want)
        want = want.reshape(P, -1, *want.shape[1:])
        for r in range(P):
            g = got[r][:counts[r]].numpy()
            w = want[r, :counts[r]]
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def _keys(n: int, case: str, P: int = 8, seed: int = 0) -> np.ndarray:
    """Keys of a distribution; "adversarial" is reverse block-sorted for P
    ranks (rank i holds rank P-1-i's output range)."""
    rng = np.random.default_rng(seed + n)
    if case == "random":
        keys = Pcg32(state=n + seed).fill(n)
        keys[::5] = keys[:1]  # ties across ranks
        return keys
    if case == "duplicates":
        return rng.choice(np.array([3, 3, 3, 7, 0xFFFFFFFF], np.uint32), size=n)
    if case == "all_equal":
        return np.full(n, 42, np.uint32)
    if case == "presorted":
        return np.sort(Pcg32(state=n).fill(n))
    if case == "skewed":
        return generate_zipf_keys(n, alpha=1.2, seed=5)
    if case == "max_keys":
        keys = Pcg32(state=n).fill(n)
        keys[::3] = 0xFFFFFFFF
        return keys
    assert case == "adversarial"
    s = np.sort(Pcg32(state=n).fill(n))
    return s.reshape(P, -1)[::-1].reshape(-1).copy()


# ---------------------------------------------------------------------------
# 32-bit keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reassembly", ["sort", "merge"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("P", RANKS)
def test_shards_match_jax(P, n, reassembly):
    """build_sample_sort: each rank's count and valid prefix equal JAX's
    (its "sort" reassembly, for either of the port's)."""
    keys = _padded(_keys(n, "random"), P, 0xFFFFFFFF)
    n_local = keys.size // P
    jfn, jcap = _jax_fn("keys", P, n_local, 1.5)
    fn, cap = ss.build_sample_sort(_cpu_mesh(P), n_local, reassembly=reassembly)
    assert cap == jcap
    buffers, counts, overflow = fn(_port_put(keys, P))
    jbuffers, jcounts, joverflow = jfn(_jax_put(keys, P))
    assert all(b.shape == (P * cap + n_local,) and b.dtype == torch.uint32 for b in buffers)
    _same_ranks(P, counts, [buffers], jcounts, [jbuffers], overflow, joverflow)


CASES = ["duplicates", "all_equal", "presorted", "skewed", "max_keys", "adversarial"]
# the JAX package's own cases (tests/test_sample_sort.py:19-157) and factors
FACTORS = {"duplicates": 1.2, "all_equal": 1.0, "presorted": 1.0, "skewed": 2.5,
           "max_keys": 1.5, "adversarial": 1.0}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("P", [3, 8])
def test_distributions_match_jax(P, case):
    """Duplicates, all-equal, presorted, skewed, max keys and adversarial
    placement: the same per-rank counts and prefixes, the same overflows;
    with fallback the exact sort, without it OverflowError_ exactly where
    JAX raises."""
    n, factor = 4096 + 3 * P, FACTORS[case]
    keys = _keys(n - n % P if case == "adversarial" else n, case, P)
    padded = _padded(keys, P, 0xFFFFFFFF)
    n_local = padded.size // P
    jfn, _ = _jax_fn("keys", P, n_local, factor)
    fn, _ = ss.build_sample_sort(_cpu_mesh(P), n_local, capacity_factor=factor)
    jout = jfn(_jax_put(padded, P))
    out = fn(_port_put(padded, P))
    _same_ranks(P, out[1], [out[0]], jout[1], [jout[0]], out[2], jout[2])
    assert bool(int(jout[2])) == (case == "adversarial")
    for reassembly in ("sort", "merge"):
        got = ss.sort_distributed_sample(keys, mesh=_cpu_mesh(P), capacity_factor=factor,
                                         reassembly=reassembly)
        np.testing.assert_array_equal(got.numpy(), np.sort(keys))
    if int(jout[2]):
        with pytest.raises(jdist.OverflowError_):
            js.sort_distributed_sample(keys, mesh=_jax_mesh(P), capacity_factor=factor,
                                       fallback=False)
        with pytest.raises(OverflowError_, match="pair capacity overflowed"):
            ss.sort_distributed_sample(keys, mesh=_cpu_mesh(P), capacity_factor=factor,
                                       fallback=False)
    else:
        got = ss.sort_distributed_sample(keys, mesh=_cpu_mesh(P), capacity_factor=factor,
                                         fallback=False)
        np.testing.assert_array_equal(got.numpy(), np.sort(keys))


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_typed_keys_match_jax(dtype):
    """int32 and float32 through the order-preserving codec (NaNs of both
    signs, +-0.0 and the infinities): JAX's bytes, both reassemblies."""
    raw = Pcg32(state=9).fill(1111)
    raw[:8] = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00001, 0xFFC00000,
               0x80000000, 0x00000000]
    keys = raw.view(dtype)
    want = js.sort_distributed_sample(keys, mesh=_jax_mesh(8))
    for reassembly in ("sort", "merge"):
        got = ss.sort_distributed_sample(torch.from_numpy(keys), mesh=_cpu_mesh(8),
                                         reassembly=reassembly).numpy()
        assert got.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", SIZES)
def test_host_entry_matches_jax(n):
    """sort_distributed_sample on numpy input, 3 ranks: JAX's bytes."""
    keys = _keys(n, "random")
    want = js.sort_distributed_sample(keys, mesh=_jax_mesh(3))
    got = ss.sort_distributed_sample(keys, mesh=_cpu_mesh(3))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)


def test_merge_reassembly_through_the_emulated_kernel(monkeypatch):
    """The "merge" reassembly with B2's arithmetic (merge_level_emulated,
    blocks of 64 keys) in place of its plain version: exact, on runs of the
    capacity with a short last run of each parity."""
    calls = []

    def emulated(x, L):
        calls.append(L)
        return ms.merge_level_emulated(x, L, threads=16, items=4)

    monkeypatch.setattr(ms, "merge_level", emulated)
    for P, n in ((3, 4099), (8, 4099), (2, 1000)):
        keys = _keys(n, "random")
        got = ss.sort_distributed_sample(keys, mesh=_cpu_mesh(P), reassembly="merge")
        np.testing.assert_array_equal(got.numpy(), np.sort(keys))
    assert calls


def test_rejects_bad_reassembly_and_keys():
    with pytest.raises(ValueError, match="reassembly"):
        ss.build_sample_sort(_cpu_mesh(2), 2048, reassembly="bogus")
    with pytest.raises(ValueError, match="reassembly"):
        js.build_sample_sort(_jax_mesh(2), 2048, reassembly="bogus")
    with pytest.raises(TypeError, match="unsupported key dtype"):
        ss.sort_distributed_sample(torch.zeros(4, dtype=torch.int64), mesh=_cpu_mesh(2))
    fn, _ = ss.build_sample_sort(_cpu_mesh(2), 8)
    with pytest.raises(ValueError, match="shards"):
        fn([torch.zeros(8, dtype=torch.uint32)])


# ---------------------------------------------------------------------------
# key-value rows
# ---------------------------------------------------------------------------

def _kv_rows(n: int, W: int, seed: int = 2):
    """Keys with many ties (so stability shows) and provenance lanes."""
    rng = np.random.default_rng(seed + n)
    keys = rng.integers(0, 1 << 6, n).astype(np.uint32) << np.uint32(26)
    keys[::7] = 0xFFFFFFFF
    vals = rng.integers(0, 1 << 32, (n, W), dtype=np.uint64).astype(np.uint32)
    if W:
        vals[:, 0] = np.arange(n, dtype=np.uint32)
    return keys, vals


def _stable(keys: np.ndarray, vals: np.ndarray):
    order = np.argsort(keys, kind="stable")
    return keys[order], vals[order]


KV_CASES = [(P, n, 2) for P in RANKS for n in SIZES] + [
    (3, 1111, 1), (8, 4099, 1), (3, 1111, 9), (8, 4099, 9)]


@pytest.mark.parametrize("P,n,W", KV_CASES)
def test_kv_shards_match_jax(P, n, W):
    """build_sample_sort_kv: counts and valid prefixes of keys and payload
    lanes equal JAX's; W = 1, 2 and 9 lanes (JAX moves > 4 lanes by a
    gather, fewer as sort operands)."""
    keys, vals = _kv_rows(n, W)
    pk, pv = _padded(keys, P, 0xFFFFFFFF), _padded(vals, P, 0)
    n_local = pk.size // P
    jfn, _ = _jax_fn("kv", P, n_local, 4.0, W)
    fn, _ = ss.build_sample_sort_kv(_cpu_mesh(P), n_local, W, capacity_factor=4.0)
    mk, mv, counts, overflow = fn(_port_put(pk, P), _port_put(pv, P))
    jmk, jmv, jcounts, joverflow = jfn(_jax_put(pk, P), _jax_put(pv, P))
    assert int(joverflow) == 0
    _same_ranks(P, counts, [mk, mv], jcounts, [jmk, jmv], overflow, joverflow)


@pytest.mark.parametrize("P", RANKS)
def test_kv_host_entry_is_stable_and_matches_jax(P):
    keys, vals = _kv_rows(4099, 2)
    jk, jv = js.sort_key_value_distributed(keys, vals, mesh=_jax_mesh(P), capacity_factor=4.0)
    gk, gv = ss.sort_key_value_distributed(keys, vals, mesh=_cpu_mesh(P), capacity_factor=4.0)
    np.testing.assert_array_equal(gk.numpy(), jk)
    np.testing.assert_array_equal(gv.numpy(), jv)
    wk, wv = _stable(keys, vals)
    np.testing.assert_array_equal(gk.numpy(), wk)
    np.testing.assert_array_equal(gv.numpy(), wv)


@pytest.mark.parametrize("case", ["max_key", "byte_payload", "all_equal", "presorted",
                                  "wide_zero_rows"])
def test_kv_cases_match_jax(case):
    """The JAX package's kv cases (tests/test_sample_sort.py:95-157) on 8
    ranks: a real 0xFFFFFFFF key keeps its payload beside the padding; 64-byte
    payloads; all-equal and presorted keys at factor 1.0 (self-destined);
    and empty input with a wide payload."""
    factor = 1.5
    if case == "max_key":
        keys = np.array([0xFFFFFFFF, 5, 0xFFFFFFFF, 5, 0xFFFFFFFF] * 5, np.uint32)
        vals = np.arange(25, dtype=np.uint32).reshape(-1, 1)
    elif case == "byte_payload":
        keys = Pcg32().fill(4099)
        vals = generate_payloads(4099, payload_bytes=64)
    elif case == "all_equal":
        keys, factor = np.full(1 << 12, 9, np.uint32), 1.0
        vals = np.arange(1 << 12, dtype=np.uint32).reshape(-1, 1)
    elif case == "presorted":
        keys, factor = np.sort(Pcg32().fill(1 << 12)), 1.0
        vals = np.arange(1 << 12, dtype=np.uint32).reshape(-1, 1)
    else:
        keys, vals = np.zeros(0, np.uint32), np.zeros((0, 64), np.uint8)
    gk, gv = ss.sort_key_value_distributed(torch.from_numpy(keys), torch.from_numpy(vals),
                                           mesh=_cpu_mesh(8), capacity_factor=factor)
    assert gv.dtype == torch.from_numpy(vals).dtype and gv.shape == vals.shape
    if case == "wide_zero_rows":
        # JAX fails here (its host wrapper reshapes (0, 16) lanes to
        # (0, -1)); the port is held against numpy alone
        with pytest.raises(ValueError, match="reshape"):
            js.sort_key_value_distributed(keys, vals, mesh=_jax_mesh(8))
    else:
        jk, jv = js.sort_key_value_distributed(keys, vals, mesh=_jax_mesh(8),
                                               capacity_factor=factor)
        np.testing.assert_array_equal(gk.numpy(), jk)
        np.testing.assert_array_equal(gv.numpy(), jv)
    wk, wv = _stable(keys, vals)
    np.testing.assert_array_equal(gk.numpy(), wk)
    np.testing.assert_array_equal(gv.numpy(), wv)


def test_kv_overflow_raises_where_jax_raises():
    """Duplicate mass poured across ranks onto one destination overflows the
    kv exchange; there is no fallback on the kv path, in either package."""
    P, n = 8, 8 * 512
    keys = np.sort(Pcg32(state=3).fill(n))[::-1].copy()
    vals = np.arange(n, dtype=np.uint32)[:, None]
    with pytest.raises(jdist.OverflowError_):
        js.sort_key_value_distributed(keys, vals, mesh=_jax_mesh(P), capacity_factor=1.0)
    with pytest.raises(OverflowError_, match="kv sample-sort"):
        ss.sort_key_value_distributed(keys, vals, mesh=_cpu_mesh(P), capacity_factor=1.0)


def test_kv_rejects_bad_payload():
    keys = Pcg32().fill(64)
    for bad, match in ((np.zeros((64, 3), np.uint8), "uint8"),
                       (np.zeros((32, 4), np.uint8), "rows"),
                       (np.zeros(64, np.uint32), "uint8")):
        with pytest.raises(ValueError, match=match):
            js.sort_key_value_distributed(keys, bad, mesh=_jax_mesh(2))
        with pytest.raises(ValueError, match=match):
            ss.sort_key_value_distributed(keys, bad, mesh=_cpu_mesh(2))


# ---------------------------------------------------------------------------
# 64-bit keys
# ---------------------------------------------------------------------------

def _u64(n: int, case: str = "random", seed: int = 19) -> np.ndarray:
    """uint64 keys: "random" with a few ties and the largest key (light
    enough that the LSD composition's 32-bit passes stay within their
    capacity), "hi_equal" with one hi word, "distinct" without ties."""
    rng = np.random.default_rng(seed + n)
    if case == "hi_equal":  # one hi word: the lo word decides
        return (np.uint64(5) << np.uint64(32)) | rng.integers(0, 8, n, dtype=np.uint64)
    keys = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    if case == "random" and n:
        keys[::37] = keys[0]
        keys[1::41] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return keys


def _words(keys: np.ndarray):
    enc = encode_ordered_np64(keys)
    return ((enc >> np.uint64(32)).astype(np.uint32),
            (enc & np.uint64(0xFFFFFFFF)).astype(np.uint32))


U64_CASES = [(P, n) for P in RANKS for n in (0, 64, 1111, 4099)]


@pytest.mark.parametrize("P,n", U64_CASES)
def test_64_shards_match_jax(P, n):
    """build_sample_sort_64 over (hi, lo) word lanes: JAX's counts and
    valid prefixes of both words."""
    hi, lo = _words(_u64(n))
    ph, pl = _padded(hi, P, 0xFFFFFFFF), _padded(lo, P, 0xFFFFFFFF)
    n_local = ph.size // P
    jfn, _ = _jax_fn("64", P, n_local, 1.5)
    fn, _ = ss.build_sample_sort_64(_cpu_mesh(P), n_local)
    mh, ml, counts, overflow = fn(_port_put(ph, P), _port_put(pl, P))
    jmh, jml, jcounts, joverflow = jfn(_jax_put(ph, P), _jax_put(pl, P))
    _same_ranks(P, counts, [mh, ml], jcounts, [jmh, jml], overflow, joverflow)


@pytest.mark.parametrize("single_pass", [True, False])
@pytest.mark.parametrize("dtype", ["uint64", "int64", "float64"])
def test_64_host_entry_matches_jax(dtype, single_pass):
    """sort_distributed_64 over uint64, int64 and float64 (NaNs of both
    signs, +-0.0, +-inf), single pass and the LSD composition: JAX's
    bytes."""
    keys = _u64(3000).view(dtype).copy()
    if dtype == "float64":
        keys[:8] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, -0.0, 0.0]
    want = js.sort_distributed_64(keys, mesh=_jax_mesh(8), single_pass=single_pass)
    got = ss.sort_distributed_64(keys, mesh=_cpu_mesh(8), single_pass=single_pass).numpy()
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


@pytest.mark.parametrize("case", ["hi_equal", "all_equal", "adversarial"])
def test_64_cases_match_jax(case):
    """Ties inside one hi word, all-equal keys, and reverse-sorted keys
    that overflow the single pass and fall through to the LSD composition:
    JAX's bytes and the same overflow."""
    n = 8 * 512
    if case == "adversarial":
        keys = np.sort(_u64(n, "distinct", seed=11))[::-1].copy()
    elif case == "all_equal":
        keys = np.full(n, 0xDEADBEEFCAFEF00D, np.uint64)
    else:
        keys = _u64(n, "hi_equal")
    hi, lo = _words(keys)
    jfn, _ = _jax_fn("64", 8, n // 8, 1.5)
    fn, _ = ss.build_sample_sort_64(_cpu_mesh(8), n // 8)
    out = fn(_port_put(hi, 8), _port_put(lo, 8))
    jout = jfn(_jax_put(hi, 8), _jax_put(lo, 8))
    _same_ranks(8, out[2], out[:2], jout[2], jout[:2], out[3], jout[3])
    assert bool(int(jout[3])) == (case == "adversarial")
    want = js.sort_distributed_64(keys, mesh=_jax_mesh(8))
    np.testing.assert_array_equal(ss.sort_distributed_64(keys, mesh=_cpu_mesh(8)).numpy(), want)
    np.testing.assert_array_equal(want, np.sort(keys))


KV64_CASES = [(P, n) for P in RANKS for n in (0, 1111, 4099)]


@pytest.mark.parametrize("P,n", KV64_CASES)
def test_kv64_shards_match_jax(P, n):
    """build_sample_sort_kv64: JAX's counts and valid prefixes of both
    words and the payload lanes."""
    keys = _u64(n)
    keys[::4] = keys[1:2] if n > 1 else keys[::4]
    hi, lo = _words(keys)
    vals = np.arange(2 * n, dtype=np.uint32).reshape(n, 2)
    ph, pl, pv = _padded(hi, P, 0xFFFFFFFF), _padded(lo, P, 0xFFFFFFFF), _padded(vals, P, 0)
    n_local = ph.size // P
    jfn, _ = _jax_fn("kv64", P, n_local, 4.0, 2)
    fn, _ = ss.build_sample_sort_kv64(_cpu_mesh(P), n_local, 2, capacity_factor=4.0)
    mh, ml, mv, counts, overflow = fn(_port_put(ph, P), _port_put(pl, P), _port_put(pv, P))
    jmh, jml, jmv, jcounts, joverflow = jfn(_jax_put(ph, P), _jax_put(pl, P), _jax_put(pv, P))
    assert int(joverflow) == 0
    _same_ranks(P, counts, [mh, ml, mv], jcounts, [jmh, jml, jmv], overflow, joverflow)


@pytest.mark.parametrize("single_pass", [True, False])
@pytest.mark.parametrize("dtype", ["uint64", "int64", "float64"])
def test_kv64_host_entry_matches_jax(dtype, single_pass):
    """sort_key_value_distributed_64 with 8-byte payload rows over uint64,
    int64 and float64 keys with ties, single pass and the LSD composition:
    JAX's bytes, and numpy's stable order."""
    n = 2048
    keys = (_u64(n, "hi_equal") if dtype == "uint64" else _u64(n)).view(dtype).copy()
    if dtype == "float64":
        keys[:8] = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, -0.0, 0.0]
    vals = np.random.default_rng(37).integers(0, 256, (n, 8), dtype=np.uint8)
    jk, jv = js.sort_key_value_distributed_64(keys, vals, mesh=_jax_mesh(8),
                                              single_pass=single_pass)
    gk, gv = ss.sort_key_value_distributed_64(keys, vals, mesh=_cpu_mesh(8),
                                              single_pass=single_pass)
    assert gk.dtype == torch.from_numpy(keys).dtype and gv.dtype == torch.uint8
    np.testing.assert_array_equal(gk.numpy().view(np.uint64), jk.view(np.uint64))
    np.testing.assert_array_equal(gv.numpy(), jv)
    order = np.argsort(encode_ordered_np64(keys), kind="stable")
    np.testing.assert_array_equal(gv.numpy(), vals[order])


@pytest.mark.parametrize("case", ["all_equal", "adversarial"])
def test_kv64_cases_match_jax(case):
    """All-equal keys (self-destined, the identity order) and reverse-sorted
    keys, whose single pass overflows into the LSD composition."""
    n = 8 * 512
    if case == "all_equal":
        keys = np.full(n, 0x0123456789ABCDEF, np.uint64)
    else:
        keys = np.sort(_u64(n, "distinct", seed=13))[::-1].copy()
    vals = np.arange(n, dtype=np.uint32)[:, None]
    jk, jv = js.sort_key_value_distributed_64(keys, vals, mesh=_jax_mesh(8))
    gk, gv = ss.sort_key_value_distributed_64(keys, vals, mesh=_cpu_mesh(8))
    np.testing.assert_array_equal(gk.numpy(), jk)
    np.testing.assert_array_equal(gv.numpy(), jv)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gv.numpy(), vals[order])


def test_64_rejects_narrow_keys_and_bad_payloads():
    for fn in (js.sort_distributed_64, ss.sort_distributed_64):
        with pytest.raises(TypeError, match="uint64"):
            fn(np.zeros(8, np.uint32), mesh=None)
    for sort, mesh in ((js.sort_key_value_distributed_64, _jax_mesh(2)),
                       (ss.sort_key_value_distributed_64, _cpu_mesh(2))):
        with pytest.raises(TypeError, match="uint64"):
            sort(np.zeros(8, np.uint32), np.zeros((8, 1), np.uint32), mesh=mesh)
        with pytest.raises(ValueError, match="rows"):
            sort(np.zeros(8, np.uint64), np.zeros((4, 1), np.uint32), mesh=mesh)


# ---------------------------------------------------------------------------
# merge_presorted
# ---------------------------------------------------------------------------

def _runs(n: int, run: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    keys[::4] = keys[:1]
    return np.concatenate([np.sort(keys[i:i + run]) for i in range(0, n, run)] or [keys])


@pytest.mark.parametrize("n,run", [(0, 1), (1, 1), (1000, 1), (1000, 7), (4096, 256),
                                   (4096 + 100, 256), (5 * 256 + 17, 256), (300, 4096)])
def test_merge_presorted_against_numpy_and_the_emulated_kernel(n, run):
    """Ascending runs with a short last run of each parity (and JAX's
    power-of-two shape): np.sort's bytes from the plain levels, and from B2's
    arithmetic (merge_level_emulated, blocks of 64 keys)."""
    x = _runs(n, run, seed=n + run)
    want = np.sort(x)
    np.testing.assert_array_equal(ms.merge_presorted(torch.from_numpy(x), run).numpy(), want)
    y = torch.from_numpy(x).view(torch.int32).clone()
    whole = n // run
    rows = y[:whole * run].view(whole, run)
    rows[1::2] = rows[1::2].flip(1)
    if whole % 2 and n % run:
        y[whole * run:] = y[whole * run:].flip(0)
    y, L = y.view(torch.uint32), run
    while L < n:
        y = ms.merge_level_emulated(y, L, threads=16, items=4)
        L *= 2
    np.testing.assert_array_equal(y.numpy(), want)


def test_merge_presorted_rejects_bad_runs():
    with pytest.raises(ValueError, match="run length"):
        ms.merge_presorted(torch.zeros(4, dtype=torch.uint32), 0)
    with pytest.raises(TypeError, match="uint32"):
        ms.merge_presorted(torch.zeros(4, dtype=torch.int32), 2)
