"""The storage plane of the PyTorch port vs the JAX package: the round loop
(sort_distrib_from_raw / _arr) on the memory, file and device (CPU)
backends, its rounds with checkpoints, the fused device loops, key-value
rows and 64-bit keys, crash and resume, and the CLI's ``sort --mode
storage``.  The same keys, made from a seed with numpy, go through both
packages; the JAX side runs XLA sorts on the CPU (no Pallas kernel).
Outputs must be equal bytes: final streams, every round's partitions, and
key-value rows.

B5's tile is cut to SMALL_TILE keys so that each binning pass runs many
tiles; one case shrinks the one-block digit sort's limit so that the
workers take binning passes instead."""

import functools
import shutil
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu import data as jdata
from gpu_radix_sort_tpu.parallel import storage_sort as jss
from gpu_radix_sort_tpu.utils.keygen import Pcg32, generate_payloads
from gpu_radix_sort_tpu_torch import data as pdata
from gpu_radix_sort_tpu_torch.cli import main as port_cli
from gpu_radix_sort_tpu_torch.data.interface import create_shape
from gpu_radix_sort_tpu_torch.ops import binning as bn
from gpu_radix_sort_tpu_torch.ops import digit_sort as ds
from gpu_radix_sort_tpu_torch.ops import single_block as sb
from gpu_radix_sort_tpu_torch.parallel import storage_sort as ss
from gpu_radix_sort_tpu_torch.utils.config import SortConfig
from gpu_radix_sort_tpu_torch.utils.timers import SortStats

N = 5000
SMALL_TILE = 256
CPU_WORKER = ss.make_local_worker(device="cpu")


@pytest.fixture(autouse=True)
def small_geometry(monkeypatch):
    monkeypatch.setattr(bn, "TILE", SMALL_TILE)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keys(n: int = N, seed: int = 3) -> np.ndarray:
    keys = Pcg32(state=seed).fill(n)
    if not n:
        return keys
    keys[::7] = keys[0]  # ties in every digit
    keys[1::11] ^= np.uint32(0xFFFF0000)  # equal low halves, other high bits
    return keys


def _port_factory(backend: str, root: str):
    if backend == "mem":
        return pdata.MemArrayFactory()
    if backend == "file":
        return pdata.FileArrayFactory(root)
    return pdata.DeviceArrayFactory("cpu")


def _jax_factory(backend: str, root: str):
    if backend == "mem":
        return jdata.MemArrayFactory()
    if backend == "file":
        return jdata.FileArrayFactory(root)
    return jdata.DeviceArrayFactory()


def _port_worker(backend: str):
    """The stock worker on the device backend (the fused loop), a local
    worker on the CPU otherwise."""
    return ss.local_distrib_worker if backend == "device" else CPU_WORKER


def _snapshot(arrs) -> list:
    return [[a.read_part(i) for i in range(a.get_shape().npart)] for a in arrs]


@functools.lru_cache(maxsize=None)
def _jax_raw(backend: str, width: int, nworker: int, n: int = N) -> bytes:
    root = tempfile.mkdtemp()
    try:
        return jss.sort_distrib_from_raw(
            _keys(n), "s", _jax_factory(backend, root), width=width, nworker=nworker
        ).tobytes()
    finally:
        shutil.rmtree(root, ignore_errors=True)


CASES = [(b, w, nw) for b in ("mem", "file", "device") for w, nw in ((4, 1), (8, 2), (8, 3))]
# empty input on every backend; the device backend also at widths 1, 2 and
# 16 and up to 7 workers
EMPTY_CASES = [(b, 8, 2) for b in ("mem", "file")] + [
    ("device", w, nw) for w, nw in ((1, 2), (2, 5), (8, 3), (16, 7))]


@pytest.mark.parametrize("backend,width,nworker,n", [
    pytest.param(b, w, nw, N, id=f"{b}-{w}-{nw}") for b, w, nw in CASES + [("mem", 16, 2)]
] + [pytest.param(b, w, nw, 0, id=f"{b}-{w}-{nw}-empty") for b, w, nw in EMPTY_CASES])
def test_sort_distrib_from_raw_matches_jax(backend, width, nworker, n, tmp_path):
    keys = _keys(n)
    stats = SortStats()
    got = ss.sort_distrib_from_raw(
        keys, "s", _port_factory(backend, str(tmp_path)), _port_worker(backend),
        width=width, nworker=nworker, stats=stats,
    )
    assert got.dtype == np.uint32 and got.shape == (n,)
    assert got.tobytes() == _jax_raw(backend, width, nworker, n)
    np.testing.assert_array_equal(got, np.sort(keys))
    assert stats.counters["rounds"] == 32 // width


def test_workers_through_binning_passes(monkeypatch):
    """Shards above the one-block digit sort's limit take binning passes
    (B5's plain version): the same bytes."""
    monkeypatch.setattr(ds, "MAX_N_KV", 256)
    got = ss.sort_distrib_from_raw(_keys(), "s", pdata.MemArrayFactory(), CPU_WORKER,
                                   width=8, nworker=3)
    assert got.tobytes() == _jax_raw("mem", 8, 3)


def _record_checkpoints(monkeypatch, module, rounds: list, manifests: list):
    original = module._write_checkpoint

    def wrapper(checkpoint_dir, name, step, width, arrs, *args, **kwargs):
        original(checkpoint_dir, name, step, width, arrs, *args, **kwargs)
        rounds.append((step, [a.name for a in arrs], _snapshot(arrs)))
        manifests.append(module.load_checkpoint(checkpoint_dir, name))

    monkeypatch.setattr(module, "_write_checkpoint", wrapper)


@pytest.mark.parametrize("backend,width,nworker", [
    ("mem", 8, 2), ("file", 8, 3), ("device", 8, 2), ("device", 8, 3)])
def test_checkpointed_rounds_match_jax(backend, width, nworker, tmp_path, monkeypatch):
    """With a checkpoint_dir, every round's arrays equal the JAX package's,
    partition by partition (the device backend: both fused round loops),
    and so do the manifests, but for the port's key_bits."""
    sides = []
    for module, factory, worker, root in (
        (jss, _jax_factory, jss.local_distrib_worker, tmp_path / "jax"),
        (ss, _port_factory, _port_worker(backend), tmp_path / "port"),
    ):
        rounds, manifests = [], []
        _record_checkpoints(monkeypatch, module, rounds, manifests)
        got = module.sort_distrib_from_raw(
            _keys(), "c", factory(backend, str(root / "arrays")), worker, width=width,
            nworker=nworker, checkpoint_dir=str(root / "ckpt"),
        )
        np.testing.assert_array_equal(got, np.sort(_keys()))
        sides.append((rounds, manifests))
    (jax_rounds, jax_manifests), (port_rounds, port_manifests) = sides
    assert len(port_rounds) == 32 // width
    assert port_rounds == jax_rounds
    for jm, pm in zip(jax_manifests, port_manifests):
        assert pm.pop("key_bits") == 32
        assert pm == jm


def _staged(module, factory, name: str, keys: np.ndarray):
    arr = factory.create(f"{name}.input", module.create_shape([keys.nbytes]))
    arr.write_part(0, keys.tobytes())
    arr.close()
    return arr


@pytest.mark.parametrize("route", ["one_block", "merge"])
@pytest.mark.parametrize("width,nworker", [(4, 1), (8, 2), (8, 3)])
def test_fused_loop_matches_jax_array_by_array(width, nworker, route, monkeypatch):
    """The fused all-rounds loop's output arrays equal the JAX package's
    fused loop's, partition by partition (within a bucket both keep value
    order); ``merge`` sends sort_full through the tile pass and the merge
    levels (their plain versions)."""
    if route == "merge":
        monkeypatch.setattr(sb, "MAX_N", 256)
    keys = _keys()
    jf = jdata.DeviceArrayFactory()
    jout = jss.sort_distrib_from_arr([_staged(jss, jf, "f", keys)], "f", jf,
                                     jss.local_distrib_worker, width=width, nworker=nworker)
    pf = pdata.DeviceArrayFactory("cpu")
    pout = ss.sort_distrib_from_arr([_staged(ss, pf, "f", keys)], "f", pf,
                                    ss.local_distrib_worker, width=width, nworker=nworker)
    assert [a.name for a in pout] == [a.name for a in jout]
    assert _snapshot(pout) == _snapshot(jout)


@pytest.mark.parametrize("checkpoint", [False, True])
@pytest.mark.parametrize("width,nworker", [(8, 2), (4, 3)])
def test_fused_against_unfused_per_bucket(width, nworker, checkpoint, tmp_path):
    """Fused and per-worker loops of the port give every bucket as the same
    multiset (and the per-worker loop the stable order itself)."""
    keys = _keys()
    outs = []
    for worker in (ss.local_distrib_worker, ss.make_local_worker("auto")):
        f = pdata.DeviceArrayFactory("cpu")
        ckpt = str(tmp_path / f"ck{len(outs)}") if checkpoint else None
        outs.append(_snapshot(ss.sort_distrib_from_arr(
            [_staged(ss, f, "u", keys)], "u", f, worker, width=width, nworker=nworker,
            checkpoint_dir=ckpt)))
    fused, unfused = outs
    for fa, ua in zip(fused, unfused):
        for fp, up in zip(fa, ua):
            assert sorted(np.frombuffer(fp, np.uint32)) == sorted(np.frombuffer(up, np.uint32))
    stream = b"".join(unfused[w][d] for d in range(1 << width) for w in range(nworker))
    np.testing.assert_array_equal(np.frombuffer(stream, np.uint32), np.sort(keys))


@pytest.mark.parametrize("worker", ["fused", "per_worker"])
def test_committed_arrays_keep_their_bytes(worker, tmp_path, monkeypatch):
    """No round writes into the views of committed data: each round's
    arrays hold the same bytes when the next round has committed, and the
    caller's input tensor is unchanged."""
    snapshots = []
    original = ss._write_checkpoint

    def check_previous(checkpoint_dir, name, step, width, arrs, *args, **kwargs):
        if snapshots:
            prev_arrs, prev_bytes = snapshots[-1]
            assert _snapshot(prev_arrs) == prev_bytes, f"round {step - 1} changed"
        snapshots.append((arrs, _snapshot(arrs)))
        original(checkpoint_dir, name, step, width, arrs, *args, **kwargs)

    monkeypatch.setattr(ss, "_write_checkpoint", check_previous)
    keys = torch.from_numpy(_keys())
    before = keys.clone()
    f = pdata.DeviceArrayFactory("cpu")
    arr_in = f.create("v.input", create_shape([keys.numel() * 4]))
    arr_in.put_device_part(0, keys.view(torch.uint8))
    w = ss.local_distrib_worker if worker == "fused" else ss.make_local_worker("auto")
    outs = ss.sort_distrib_from_arr([arr_in], "v", f, w, width=8, nworker=2,
                                    checkpoint_dir=str(tmp_path))
    assert len(snapshots) == 4
    assert torch.equal(keys, before)
    stream = b"".join(o.read_part(d) for d in range(256) for o in outs)
    np.testing.assert_array_equal(np.frombuffer(stream, np.uint32), np.sort(before.numpy()))


@functools.lru_cache(maxsize=None)
def _jax_kv(backend: str, payload_bytes: int) -> tuple[bytes, bytes]:
    root = tempfile.mkdtemp()
    try:
        keys = _keys(2000, seed=payload_bytes)
        payload = generate_payloads(keys.size, payload_bytes=payload_bytes, seed=5)
        k, p = jss.sort_distrib_from_raw_kv(keys, payload, "kv", _jax_factory(backend, root),
                                            width=8, nworker=2)
        return k.tobytes(), p.tobytes()
    finally:
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("backend", ["mem", "file", "device"])
@pytest.mark.parametrize("payload_bytes", [8, 64])
def test_kv_rows_match_jax(backend, payload_bytes, tmp_path):
    keys = _keys(2000, seed=payload_bytes)
    payload = generate_payloads(keys.size, payload_bytes=payload_bytes, seed=5)
    k, p = ss.sort_distrib_from_raw_kv(
        keys, payload, "kv", _port_factory(backend, str(tmp_path)),
        ss.make_kv_worker(4 + payload_bytes, device="cpu"), width=8, nworker=2,
    )
    assert (k.tobytes(), p.tobytes()) == _jax_kv(backend, payload_bytes)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k, keys[order])
    np.testing.assert_array_equal(p, payload[order])


def _keys64(dtype: str, n: int = 3000) -> np.ndarray:
    words = (Pcg32(state=64).fill(2 * n).view(np.uint64))
    words[::5] = words[0]
    if dtype == "uint64":
        return words
    if dtype == "int64":
        return words.view(np.int64)
    x = np.random.default_rng(64).standard_normal(n) * 1e3
    x[::9] = x[1]
    x[:6] = [np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf]
    return x


@functools.lru_cache(maxsize=None)
def _jax_u64(backend: str, dtype: str) -> bytes:
    return jss.sort_distrib_from_raw_u64(_keys64(dtype), "u", _jax_factory(backend, ""),
                                         width=8, nworker=2).tobytes()


@pytest.mark.parametrize("backend", ["mem", "device"])
@pytest.mark.parametrize("dtype", ["uint64", "int64", "float64"])
def test_u64_keys_match_jax(backend, dtype):
    """64-bit keys (NaNs, +-0.0 among the floats): the device backend takes
    the fused 64-bit loop in both packages, mem the per-worker loop."""
    keys = _keys64(dtype)
    got = ss.sort_distrib_from_raw_u64(keys, "u", _port_factory(backend, ""),
                                       ss.make_kv_worker(8, 64, device="cpu"),
                                       width=8, nworker=2)
    assert got.dtype == keys.dtype
    assert got.tobytes() == _jax_u64(backend, dtype)
    if dtype != "float64":
        np.testing.assert_array_equal(got, np.sort(keys))


@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_kv64_rows_match_jax(dtype):
    keys = _keys64(dtype, 2000)
    payload = generate_payloads(keys.size, payload_bytes=8, seed=6)
    want = jss.sort_distrib_from_raw_kv64(keys, payload, "k", jdata.MemArrayFactory(),
                                          width=8, nworker=3)
    got = ss.sort_distrib_from_raw_kv64(keys, payload, "k", pdata.MemArrayFactory(),
                                        ss.make_kv_worker(16, 64, device="cpu"),
                                        width=8, nworker=3)
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1].tobytes() == want[1].tobytes()


class Crash(RuntimeError):
    pass


def _crashing(worker, at_offset: int):
    def crashing(in_refs, offset, width, out_name, factory):
        if offset == at_offset:
            raise Crash(f"worker down at offset {offset}")
        return worker(in_refs, offset, width, out_name, factory)

    return crashing


@pytest.mark.parametrize("backend", ["mem", "file", "device"])
def test_crash_in_round_three_then_resume_is_exact(backend, tmp_path):
    keys = _keys()
    f = _port_factory(backend, str(tmp_path / "arrays"))
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(Crash):
        ss.sort_distrib_from_raw(keys, "r", f, _crashing(CPU_WORKER, 16), width=8,
                                 nworker=2, checkpoint_dir=ckpt)
    manifest = ss.load_checkpoint(ckpt, "r")
    assert manifest["completed_step"] == 1 and manifest["key_bits"] == 32
    outs = ss.resume_sort_distrib("r", f, _port_worker(backend), ckpt, nworker=2)
    stream = b"".join(o.read_part(d) for d in range(256) for o in outs)
    np.testing.assert_array_equal(np.frombuffer(stream, np.uint32), np.sort(keys))
    assert ss.load_checkpoint(ckpt, "r")["completed_step"] == 3


def test_key_bits_mismatch_is_refused_before_any_round(tmp_path):
    keys = _keys64("uint64", 1000)
    f = pdata.FileArrayFactory(str(tmp_path / "arrays"))
    ckpt = str(tmp_path / "ckpt")
    worker64 = ss.make_kv_worker(8, 64, device="cpu")
    with pytest.raises(Crash):
        ss.sort_distrib_from_raw_u64(keys, "m", f, _crashing(worker64, 40), width=8,
                                     nworker=2, checkpoint_dir=ckpt)
    manifest = ss.load_checkpoint(ckpt, "m")
    assert (manifest["key_bits"], manifest["total_bits"], manifest["completed_step"]) == (64, 64, 4)
    calls = []
    worker32 = ss.make_kv_worker(8, 32, device="cpu")

    def counting(*args):
        calls.append(args)
        return worker32(*args)

    counting.key_bits = 32
    with pytest.raises(ValueError, match="64-bit keys but the worker sorts 32-bit"):
        ss.resume_sort_distrib("m", f, counting, ckpt, nworker=2)
    assert not calls
    assert all(f.open(name).get_shape() for name in manifest["arrays"])  # nothing swept
    with pytest.raises(ValueError, match="worker sorts 32-bit"):
        ss.sort_distrib_from_arr([f.open(n) for n in manifest["arrays"]], "m2", f, counting,
                                 total_bits=64, row_bytes=8)
    assert not calls
    outs = ss.resume_sort_distrib("m", f, worker64, ckpt, nworker=2)
    got = b"".join(o.read_part(d) for d in range(256) for o in outs)
    np.testing.assert_array_equal(ss._decode_rows_64(np.frombuffer(got, np.uint8), np.uint64),
                                  np.sort(keys))


def test_port_resumes_a_sort_the_jax_package_checkpointed(tmp_path):
    """A manifest without key_bits, as the JAX package writes it, and its
    file arrays: the port resumes the sort and ends exact."""
    keys = _keys()
    root, ckpt = str(tmp_path / "arrays"), str(tmp_path / "ckpt")
    with pytest.raises(Crash):
        jss.sort_distrib_from_raw(keys, "j", jdata.FileArrayFactory(root),
                                  _crashing(jss.local_distrib_worker, 24), width=8,
                                  nworker=2, checkpoint_dir=ckpt)
    assert "key_bits" not in ss.load_checkpoint(ckpt, "j")
    f = pdata.FileArrayFactory(root)
    outs = ss.resume_sort_distrib("j", f, CPU_WORKER, ckpt, nworker=3)
    stream = b"".join(o.read_part(d) for d in range(256) for o in outs)
    np.testing.assert_array_equal(np.frombuffer(stream, np.uint32), np.sort(keys))


@pytest.mark.parametrize("backend", ["mem", "device"])
def test_three_sorts_from_three_threads_at_once(backend):
    """Three round loops share one factory and run at once, each with its
    own worker threads: no sort sees another's arrays or buffers."""
    f = _port_factory(backend, "")
    inputs = [_keys(3000 + 500 * i, seed=10 + i) for i in range(3)]
    results, errors = [None] * 3, []
    barrier = threading.Barrier(3)

    def run(i):
        try:
            barrier.wait()
            results[i] = ss.sort_distrib_from_raw(
                inputs[i], f"t{i}", f, _port_worker(backend), width=8, nworker=2)
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    for keys, got in zip(inputs, results):
        np.testing.assert_array_equal(got, np.sort(keys))


@pytest.mark.parametrize("backend,fused", [("mem", False), ("device", True), ("device", False)])
def test_sort_stats_phases(backend, fused, tmp_path):
    stats = SortStats()
    worker = ss.local_distrib_worker if fused else ss.make_local_worker("auto", device="cpu")
    ss.sort_distrib_from_raw(_keys(1000), "p", _port_factory(backend, ""), worker,
                             width=8, nworker=2, stats=stats, checkpoint_dir=str(tmp_path))
    rep = stats.report()
    rounds = ("round_sort", "counts_d2h", "commit") if fused else ("workers",)
    for phase in ("stage_input", "split", "checkpoint", "destroy", "linearize", *rounds):
        assert rep[phase]["n"] >= 1 and rep[phase]["total_s"] >= 0.0, phase
    assert rep["checkpoint"]["n"] == 4 and rep["counter:rounds"] == 4
    assert '"linearize"' in stats.dumps()


def test_storage_plane_needs_cuda_unless_asked_for_the_cpu():
    """The default worker sends host keys to the CUDA device, and the
    device backend lives there: with none, both raise; nothing falls back."""
    if torch.cuda.is_available():
        assert pdata.DeviceArrayFactory().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ss.sort_distrib_from_raw(_keys(100), "x", pdata.MemArrayFactory())
    with pytest.raises(RuntimeError, match="CUDA"):
        ss.sort_distrib_from_raw_kv(_keys(100), np.zeros((100, 4), np.uint8), "x",
                                    pdata.MemArrayFactory())
    with pytest.raises(RuntimeError, match="CUDA"):
        pdata.DeviceArrayFactory()


def test_sort_config_validates_against_the_port():
    cfg = SortConfig(backend="device", device="cpu").validate()
    assert isinstance(cfg.make_factory(), pdata.DeviceArrayFactory)
    assert cfg.make_worker()._fused_device_strategy is None
    assert SortConfig(strategy="torch", device="cpu").make_worker()._fused_device_strategy == "torch"
    for bad in (dict(strategy="xla"), dict(strategy="pallas"), dict(width=5),
                dict(backend="disk"), dict(worker="pool"), dict(backend="file"),
                dict(device="tpu"), dict(exchange="ring")):
        with pytest.raises(ValueError):
            SortConfig(**bad).validate()


def test_sort_config_reads_the_environment(monkeypatch):
    monkeypatch.setenv("GRS_WIDTH", "4")
    monkeypatch.setenv("GRS_DEVICE", "cpu")
    monkeypatch.setenv("GRS_BACKEND", "device")
    cfg = SortConfig.from_env(nworker=3)
    assert (cfg.width, cfg.device, cfg.backend, cfg.nworker) == (4, "cpu", "device", 3)
    monkeypatch.setenv("GRS_WIDTH", "four")
    with pytest.raises(ValueError, match="GRS_WIDTH"):
        SortConfig.from_env()


@pytest.mark.parametrize("backend", ["mem", "file", "device"])
def test_cli_sort_mode_storage(backend, tmp_path, capsys):
    keys = _keys(3000)
    src, out = tmp_path / "keys.bin", tmp_path / "out.bin"
    keys.tofile(src)
    args = ["sort", "--mode", "storage", "--in", str(src), "--out", str(out), "--device",
            "cpu", "--backend", backend, "--width", "8", "--nworker", "3", "--verify",
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    if backend == "file":
        args += ["--mount", str(tmp_path / "mount")]
    assert port_cli(args) == 0
    assert "EXACT MATCH" in capsys.readouterr().err
    np.testing.assert_array_equal(np.fromfile(out, np.uint32), np.sort(keys))
    assert ss.load_checkpoint(str(tmp_path / "ckpt"), "cli")["completed_step"] == 3
