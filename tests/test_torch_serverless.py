"""Subprocess workers of the PyTorch port vs the JAX package: the JSON wire
format, the event handler (an event built by the JAX package, handled by
both packages: the same output bytes), the persistent WorkerPool (sorts
through it give the JAX package's bytes; worker errors come back in the
response; a dead worker is respawned), one-shot workers, the worker child's
imports and the device contract of the children: on the CUDA device unless
``device="cpu"`` is asked for, and a failure reported when there is none.
The children run ``python -m gpu_radix_sort_tpu_torch.parallel.worker_main``
with GRS_DEVICE=cpu here."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu import data as jdata
from gpu_radix_sort_tpu.parallel import serverless as jsv
from gpu_radix_sort_tpu.parallel import storage_sort as jss
from gpu_radix_sort_tpu.utils.keygen import Pcg32, generate_payloads
from gpu_radix_sort_tpu_torch import data as pdata
from gpu_radix_sort_tpu_torch.data import PartRef, create_shape
from gpu_radix_sort_tpu_torch.parallel import serverless as sv
from gpu_radix_sort_tpu_torch.parallel import storage_sort as ss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool_mount(tmp_path_factory):
    return str(tmp_path_factory.mktemp("pool_mount"))


@pytest.fixture(scope="module")
def pool(pool_mount):
    with sv.WorkerPool(pool_mount, size=2, device="cpu") as p:
        yield p


def _keys(n: int, seed: int = 1) -> np.ndarray:
    keys = Pcg32(state=seed).fill(n)
    keys[::5] = keys[0]
    return keys


def _input_array(factory, name: str, data: bytes):
    arr = factory.create(name, create_shape([len(data)]))
    arr.write_part(0, data)
    arr.close()
    return arr


def test_wire_round_trip_matches_jax(tmp_path):
    f = pdata.FileArrayFactory(str(tmp_path))
    arr = _input_array(f, "wire", bytes(range(64)))
    ref = PartRef(arr, 0, 8, 16)
    wire = sv.part_ref_to_wire(ref)
    assert wire == {"arrayName": "wire", "partID": 0, "start": 8, "nbyte": 16}
    cache = {}
    back = sv.wire_to_part_ref(json.loads(json.dumps(wire)), f, cache)
    assert (back.arr.name, back.part_idx, back.start, back.nbyte) == ("wire", 0, 8, 16)
    assert back.reader().read() == bytes(range(8, 24))
    assert sv.wire_to_part_ref(wire, f, cache).arr is back.arr
    for row_bytes, key_bits in ((4, 32), (12, 32), (8, 64), (24, 64)):
        assert sv.build_event([ref], 8, 4, "o", row_bytes, key_bits) == jsv.build_event(
            [ref], 8, 4, "o", row_bytes, key_bits)
    assert set(sv.build_event([ref], 0, 8, "o")) == {"offset", "width", "arrType",
                                                     "input", "output"}


@pytest.mark.parametrize("row_bytes,key_bits", [(4, 32), (12, 32), (8, 64), (72, 64)])
def test_jax_event_handled_by_the_port_gives_jax_bytes(tmp_path, row_bytes, key_bits):
    """An event made by the JAX package's build_event over arrays written by
    its file backend: the port's handle_event writes the bytes that the
    JAX package's handler writes."""
    root = str(tmp_path)
    n = 3001
    rows = np.frombuffer(Pcg32(state=row_bytes).fill(n * row_bytes // 4).tobytes(), np.uint8)
    rows = rows.reshape(n, row_bytes).copy()
    rows[::6, :8] = rows[0, :8]  # ties in the key
    jf = jdata.FileArrayFactory(root)
    arr = _input_array(jf, "in", rows.tobytes())
    nbyte = (n // 2) * row_bytes
    refs = [jdata.PartRef(arr, 0, row_bytes * 7, nbyte), jdata.PartRef(arr, 0, 0, row_bytes * 7)]
    offset = 40 if key_bits == 64 else 8
    event = jsv.build_event(refs, offset, 8, "jax_out", row_bytes, key_bits)
    jout = jsv.handle_event(event, jf)
    pout = sv.handle_event(dict(event, output="port_out"), pdata.FileArrayFactory(root),
                           device="cpu")
    jshape = jdata.FileArrayFactory(root).open("port_out").get_shape()
    assert (pout.get_shape().lens, pout.get_shape().caps) == (jshape.lens, jshape.caps)
    assert jshape.lens == jout.get_shape().lens
    assert [pout.read_part(d) for d in range(256)] == [jout.read_part(d) for d in range(256)]


def test_handle_event_rejects_bad_arrtype(tmp_path):
    with pytest.raises(ValueError, match="arrType"):
        sv.handle_event({"arrType": "s3", "input": [], "output": "x", "offset": 0,
                         "width": 8}, pdata.FileArrayFactory(str(tmp_path)), device="cpu")


def _jax_sorted(keys, width, nworker, root) -> bytes:
    return jss.sort_distrib_from_raw(keys, "j", jdata.FileArrayFactory(root),
                                     width=width, nworker=nworker).tobytes()


@pytest.mark.parametrize("width,nworker", [(8, 2), (16, 3)])
def test_pool_sort_matches_jax(pool, pool_mount, tmp_path, width, nworker):
    keys = _keys(4000, seed=width)
    got = ss.sort_distrib_from_raw(keys, f"pool{width}", pdata.FileArrayFactory(pool_mount),
                                   pool.worker(), width=width, nworker=nworker)
    assert got.tobytes() == _jax_sorted(keys, width, nworker, str(tmp_path))
    np.testing.assert_array_equal(got, np.sort(keys))


def test_pool_kv_and_u64_rows(pool, pool_mount):
    keys = _keys(2000, seed=7)
    payload = generate_payloads(keys.size, payload_bytes=8, seed=7)
    f = pdata.FileArrayFactory(pool_mount)
    k, p = ss.sort_distrib_from_raw_kv(keys, payload, "poolkv", f, pool.worker(12), width=8)
    want = jss.sort_distrib_from_raw_kv(keys, payload, "poolkv_j", jdata.MemArrayFactory())
    assert (k.tobytes(), p.tobytes()) == (want[0].tobytes(), want[1].tobytes())
    k64 = keys.astype(np.uint64) << np.uint64(32) | np.roll(keys, 3).astype(np.uint64)
    got = ss.sort_distrib_from_raw_u64(k64, "poolu64", f, pool.worker(8, 64), width=16)
    np.testing.assert_array_equal(got, np.sort(k64))


def test_pool_reports_errors_and_respawns(pool, pool_mount):
    bad = {"offset": 0, "width": 8, "arrType": "file", "output": "never",
           "input": [{"arrayName": "no_such_array", "partID": 0, "start": 0, "nbyte": 4}]}
    res = pool.invoke(bad)
    assert res["success"] is False and "no_such_array" in res["err"]
    for proc in list(pool._procs):
        proc.kill()
        proc.wait()
    keys = _keys(1500, seed=9)
    got = ss.sort_distrib_from_raw(keys, "respawn", pdata.FileArrayFactory(pool_mount),
                                   pool.worker(), width=16, nworker=2)
    np.testing.assert_array_equal(got, np.sort(keys))
    assert len(pool._procs) == 2 and all(p.poll() is None for p in pool._procs)


def test_pool_worker_needs_the_file_backend(pool):
    with pytest.raises(TypeError, match="file backend"):
        ss.sort_distrib_from_raw(_keys(100), "m", pdata.MemArrayFactory(), pool.worker())


def test_one_shot_subprocess_workers_sort_exactly(tmp_path):
    mount = str(tmp_path)
    keys = _keys(3000, seed=11)
    worker = sv.make_subprocess_worker(mount, device="cpu")
    got = ss.sort_distrib_from_raw(keys, "oneshot", pdata.FileArrayFactory(mount), worker,
                                   width=16, nworker=2)
    np.testing.assert_array_equal(got, np.sort(keys))


def _event_for(mount: str, n: int = 500) -> dict:
    f = pdata.FileArrayFactory(mount)
    keys = _keys(n)
    arr = _input_array(f, "child_in", keys.tobytes())
    return sv.build_event([PartRef(arr, 0, 0, keys.nbytes)], 0, 8, "child_out")


def _imported(stderr: str) -> set:
    names = set()
    for line in stderr.splitlines():
        if line.startswith("import time:") and "|" in line:
            names.add(line.rsplit("|", 1)[1].strip())
    return names


def test_child_imports_neither_jax_nor_the_jax_package(tmp_path):
    """The worker child started as the pool starts it: ``-X importtime``
    lists every module it imports, and neither jax nor the JAX package is
    among them.  It handles the event on the CPU as asked."""
    mount = str(tmp_path)
    event = _event_for(mount)
    env = sv._worker_env(mount, "cpu", None)
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", sv.WORKER_MODULE],
        input=json.dumps(event).encode(), capture_output=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert json.loads(proc.stdout) == {"success": True, "err": ""}
    mods = _imported(proc.stderr.decode())
    assert {"gpu_radix_sort_tpu_torch.parallel.serverless", "torch"} <= mods
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "gpu_radix_sort_tpu"}, tops & {"jax", "jaxlib"}
    out = pdata.FileArrayFactory(mount).open("child_out")
    got = np.frombuffer(out.read_all(), np.uint32)
    np.testing.assert_array_equal(np.sort(got), np.sort(_keys(500)))


def test_child_without_cuda_reports_failure(tmp_path):
    """A child asked for the CUDA device (the default) where there is none
    answers success false; it does not sort on the CPU."""
    mount = str(tmp_path)
    res = sv.invoke_subprocess(_event_for(mount), mount)
    if torch.cuda.is_available():
        assert res["success"] is True
        return
    assert res["success"] is False and "CUDA" in res["err"]
    with pytest.raises(FileNotFoundError):
        pdata.FileArrayFactory(mount).open("child_out")


def test_cli_worker_subcommand_and_a_missing_mount(tmp_path):
    mount = str(tmp_path)
    event = _event_for(mount, 300)
    env = sv._worker_env(mount, "cpu", str(tmp_path / "prof"))
    proc = subprocess.run([sys.executable, "-m", "gpu_radix_sort_tpu_torch", "worker"],
                          input=json.dumps(event).encode(), capture_output=True, env=env,
                          timeout=300, cwd=REPO)
    assert json.loads(proc.stdout) == {"success": True, "err": ""}, proc.stderr[-2000:]
    assert any(name.endswith(".prof") for name in os.listdir(tmp_path / "prof"))
    env.pop(sv.MOUNT_ENV)
    proc = subprocess.run([sys.executable, "-m", sv.WORKER_MODULE], input=b"{}",
                          capture_output=True, env=env, timeout=300)
    assert json.loads(proc.stdout) == {"success": False, "err": "GRS_TPU_MOUNT not set"}
