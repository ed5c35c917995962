"""Out-of-process (serverless-style) distributed workers.

Port of ``gpu_radix_sort_tpu/parallel/serverless.py`` (the reference's FaaS
layer, benchmark/pkg/faas/ + faasTest/): the round loop stays backend-blind
-- a :class:`DistribWorker` that happens to serialize its PartRefs to JSON,
spawn a worker process, and re-open the worker's output array by name.

Wire protocol (the reference's JSON field names, inputs.go:13-28, and the JAX
package's extensions, unchanged):

  event  = {"offset": int, "width": int, "arrType": "file",
            "input":  [{"arrayName": str, "partID": int,
                        "start": int, "nbyte": int}, ...],
            "output": str,
            "rowBytes": int (kv rows only), "keyBits": int (64-bit only)}
  result = {"success": bool, "err": str}

Invocation is JSON over stdin/stdout of a Python interpreter running
:mod:`gpu_radix_sort_tpu_torch.parallel.worker_main` (the reference's direct
invoke, invoke.go:118-171).  The shared-filesystem rendezvous (the
reference's OL_SHARED_VOLUME, benchmark.go:79) is the ``GRS_TPU_MOUNT``
environment variable naming a FileArrayFactory root; ``GRS_PROFILE_DIR``
turns on per-event cProfile dumps, ``GRS_VERBOSE`` progress lines.

Device ownership: processes share a CUDA device, so each child sorts on its
own context of the card, ``device="cuda"`` by default, passed to it in
``GRS_DEVICE``.  A child that finds no CUDA device answers ``{"success":
false, ...}``; it never sorts on the CPU unless ``device="cpu"`` was asked
for.  (The JAX package starts its children on the CPU by default, because a
TPU chip has one owning process.)  The children load the kernel library the
parent built: it is named by the hash of the sources, so a child finds it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Sequence

from ..data.file import FileArrayFactory
from ..data.interface import ArrayFactory, DistribArray, PartRef

MOUNT_ENV = "GRS_TPU_MOUNT"
PROFILE_ENV = "GRS_PROFILE_DIR"
DEVICE_ENV = "GRS_DEVICE"
WORKER_MODULE = "gpu_radix_sort_tpu_torch.parallel.worker_main"
_ROOT = str(Path(__file__).resolve().parents[2])  # the directory holding the package


def part_ref_to_wire(ref: PartRef) -> dict:
    """PartRef -> wire dict (reference: FilePartRefToFaas, inputs.go:36-44)."""
    return {
        "arrayName": ref.arr.name,
        "partID": ref.part_idx,
        "start": ref.start,
        "nbyte": ref.nbyte,
    }


def wire_to_part_ref(
    d: dict, factory: ArrayFactory, cache: dict[str, DistribArray]
) -> PartRef:
    """Wire dict -> PartRef, with an open-array cache (reference:
    LoadFaasFilePartRef, inputs.go:46-63)."""
    name = d["arrayName"]
    arr = cache.get(name)
    if arr is None:
        arr = factory.open(name)
        cache[name] = arr
    return PartRef(arr, d["partID"], d["start"], d["nbyte"])


def build_event(
    refs: Sequence[PartRef],
    offset: int,
    width: int,
    out_name: str,
    row_bytes: int = 4,
    key_bits: int = 32,
) -> dict:
    event = {
        "offset": offset,
        "width": width,
        "arrType": "file",
        "input": [part_ref_to_wire(r) for r in refs],
        "output": out_name,
    }
    # kv rows and 64-bit keys add one field each, omitted otherwise so that
    # keys-only events stay the reference's bytes
    if row_bytes != 4:
        event["rowBytes"] = row_bytes
    if key_bits != 32:
        event["keyBits"] = key_bits
    return event


def handle_event(event: dict, factory: ArrayFactory, device=None) -> DistribArray:
    """Worker-side handler body (reference: f(event), faasTest/f.py:45-69):
    parse refs, gather, partial sort on ``device`` (the CUDA device unless
    named), bucket-partitioned output."""
    from .storage_sort import local_distrib_worker, local_distrib_worker_kv

    if event.get("arrType", "file") != "file":
        raise ValueError(f"unsupported arrType {event.get('arrType')!r}")
    cache: dict[str, DistribArray] = {}
    refs = [wire_to_part_ref(d, factory, cache) for d in event["input"]]
    row_bytes = int(event.get("rowBytes", 4))
    key_bits = int(event.get("keyBits", 32))
    if row_bytes != 4 or key_bits != 32:
        return local_distrib_worker_kv(
            refs, event["offset"], event["width"], event["output"], factory,
            row_bytes=row_bytes, key_bits=key_bits, device=device,
        )
    return local_distrib_worker(
        refs, event["offset"], event["width"], event["output"], factory, device=device
    )


def _worker_env(mount: str, device: str | None, profile_dir: str | None) -> dict:
    env = dict(os.environ)
    env[MOUNT_ENV] = mount
    if device is not None:
        env[DEVICE_ENV] = str(device)
    if profile_dir is not None:
        env[PROFILE_ENV] = profile_dir
    # the child imports this package from where the parent did
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p
    )
    return env


def invoke_subprocess(
    event: dict,
    mount: str,
    *,
    device: str | None = "cuda",
    profile_dir: str | None = None,
    timeout_s: float = 600.0,
) -> dict:
    """Spawn a worker process, deliver the event on stdin, parse the result
    JSON from stdout (reference: InvokeFaasDirect, invoke.go:118-171)."""
    proc = subprocess.run(
        [sys.executable, "-m", WORKER_MODULE],
        input=json.dumps(event).encode(),
        capture_output=True,
        env=_worker_env(mount, device, profile_dir),
        timeout=timeout_s,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"worker process failed (rc={proc.returncode}): "
            f"{proc.stderr.decode(errors='replace')[-2000:]}"
        )
    try:
        return json.loads(proc.stdout.decode())
    except json.JSONDecodeError as e:
        raise RuntimeError(
            f"worker produced invalid response: {proc.stdout[-500:]!r}"
        ) from e


def _adapt_worker(invoke_fn, row_bytes: int = 4, key_bits: int = 32):
    """Wrap an event-invoking callable into a DistribWorker: serialize refs,
    invoke, re-open the committed output array by name (reference:
    InitFaasWorker, invoke.go:174-212)."""

    def worker(
        in_refs: Sequence[PartRef],
        offset: int,
        width: int,
        out_name: str,
        factory: ArrayFactory,
    ) -> DistribArray:
        if not isinstance(factory, FileArrayFactory):
            raise TypeError(
                "subprocess workers exchange data via the file backend; got "
                f"{type(factory).__name__}"
            )
        result = invoke_fn(
            build_event(in_refs, offset, width, out_name, row_bytes, key_bits)
        )
        if not result.get("success"):
            raise RuntimeError(f"worker error: {result.get('err')}")
        return factory.open(out_name)

    worker.key_bits = key_bits
    return worker


class WorkerPool:
    """A pool of persistent worker processes serving events over pipes.

    The reference's FaaS model spawns a fresh interpreter per invocation
    (invoke.go:118-171), so every round pays the imports and the CUDA
    context; a pool keeps its workers alive across rounds.  Thread-safe:
    concurrent invokes check workers out of a free queue, matching the round
    loop's ThreadPoolExecutor.  A worker that dies is reaped and a new one
    spawned on the next invoke; errors of an event come back in its
    response.

    Use as a context manager; :meth:`worker` adapts the pool into a
    :class:`DistribWorker` for ``sort_distrib_from_arr``.
    """

    def __init__(
        self,
        mount: str,
        size: int = 2,
        *,
        device: str | None = "cuda",
        profile_dir: str | None = None,
        spawn_timeout_s: float = 120.0,
    ):
        import queue

        self._mount = mount
        self._device = device
        self._profile_dir = profile_dir
        self._spawn_timeout_s = spawn_timeout_s
        self._closed = False
        self._procs: list[subprocess.Popen] = []
        # Queue of SLOTS: a live proc, or None meaning "spawn on demand".
        # Failure paths return None to the queue, so the pool is never
        # poisoned with dead handles and its capacity is conserved.
        self._free: "queue.Queue[subprocess.Popen | None]" = queue.Queue()
        try:
            for _ in range(size):
                self._free.put(self._spawn())
        except BaseException:
            self.close()
            raise

    def _reap(self, proc: subprocess.Popen) -> None:
        if proc in self._procs:
            self._procs.remove(proc)
        if proc.poll() is None:
            proc.kill()
        proc.wait()

    def _spawn(self) -> subprocess.Popen:
        import select
        import time as _time

        proc = subprocess.Popen(
            [sys.executable, "-m", WORKER_MODULE, "--serve"],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            env=_worker_env(self._mount, self._device, self._profile_dir),
            text=True,
        )
        try:
            deadline = _time.monotonic() + self._spawn_timeout_s
            line = ""
            while _time.monotonic() < deadline:
                r, _, _ = select.select([proc.stdout], [], [], 1.0)
                if r:
                    line = proc.stdout.readline()
                    break
                if proc.poll() is not None:
                    break
            try:
                ready = bool(line) and json.loads(line).get("ready")
            except json.JSONDecodeError:
                ready = False
            if not ready:
                raise RuntimeError(
                    f"worker failed to start (rc={proc.poll()}): {line!r}"
                )
        except BaseException:
            self._reap(proc)  # never leak a half-started child
            raise
        self._procs.append(proc)
        return proc

    def invoke(self, event: dict) -> dict:
        if self._closed:
            raise RuntimeError("WorkerPool is closed")
        proc = self._free.get()
        try:
            if proc is not None and proc.poll() is not None:
                self._reap(proc)  # died since last use
                proc = None
            if proc is None:
                proc = self._spawn()
            try:
                proc.stdin.write(json.dumps(event) + "\n")
                proc.stdin.flush()
            except (BrokenPipeError, OSError) as e:
                rc = proc.poll()
                self._reap(proc)
                proc = None
                raise RuntimeError(f"worker process died mid-event (rc={rc})") from e
            line = proc.stdout.readline()
            if not line:
                rc = proc.poll()
                self._reap(proc)
                proc = None
                raise RuntimeError(f"worker process died mid-event (rc={rc})")
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                self._reap(proc)  # stdout desynced: recycle the worker
                proc = None
                raise RuntimeError(f"worker produced invalid response: {line!r}")
        finally:
            healthy = proc is not None and proc.poll() is None and proc in self._procs
            self._free.put(proc if healthy else None)

    def worker(self, row_bytes: int = 4, key_bits: int = 32):
        """Adapt the pool into a DistribWorker (kv rows via row_bytes;
        64-bit keys via key_bits)."""
        return _adapt_worker(self.invoke, row_bytes, key_bits)

    def close(self) -> None:
        self._closed = True
        for proc in list(self._procs):
            if proc.poll() is None:
                proc.stdin.close()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        self._procs.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def make_subprocess_worker(
    mount: str,
    *,
    device: str | None = "cuda",
    profile_dir: str | None = None,
    row_bytes: int = 4,
    key_bits: int = 32,
):
    """Adapt subprocess invocation into a DistribWorker (reference:
    InitFaasWorker, invoke.go:174-212): one process an event."""
    return _adapt_worker(
        lambda event: invoke_subprocess(
            event, mount, device=device, profile_dir=profile_dir
        ),
        row_bytes,
        key_bits,
    )
