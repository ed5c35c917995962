"""Receive buffers that the ranks of other processes store into: the peer
memory of the ``rdma`` and ``rdma_overlap`` exchanges on a process-group mesh.

On the TPU, ``shard_map`` over the pod hands every chip remote refs to its
peers' buffers (``gpu_radix_sort_tpu/parallel/rdma_exchange.py:60-130``,
``rdma_overlap.py:116-229``), and the Pallas kernels DMA into them.  On a
single controller one process holds every receive buffer.  On a process
group (:mod:`.multihost`) a built sort owns one :class:`PeerBuffers`:

  * it allocates the receive buffers of the process's L local ranks,
    ``n_local`` keys each, once, when the sort is built; every round and
    every call reuses them;
  * it exports a handle for each, gathers every process's handles once
    (over gloo, :func:`.mesh.side_group`), maps every peer's buffer, and
    gathers each process's outcome once more, so that afterwards every
    process has mapped every buffer, or every process raises;
  * :attr:`PeerBuffers.receivers` lists the P receive buffers in global
    rank order: the local ranks' own buffers, the peers' mapped ones.  B6
    and B7 store into them as into any receiver.

On CUDA a buffer comes from ``cudaMalloc`` (not the caching allocator, so
that the handle's base is the buffer), its handle from
``cudaIpcGetMemHandle`` and a peer's mapping from ``cudaIpcOpenMemHandle``
with lazy peer access (``csrc/exchange.cu``); each is wrapped as a tensor
without a copy.  A process cannot open its own handles, so its own ranks
use their own pointers.  Where a mapping fails (two cards that cannot
reach each other) the build raises: nothing is copied through the host.  A
mapping is closed, and an allocation freed, when the last tensor over it is
dropped.

On CPU tensors the same protocol runs over shared memory: a buffer is a
tensor over a file (``torch.from_file(..., shared=True)``) in a directory
of this process's under :data:`SHM_ROOT`, its handle the file's path, a
peer's mapping the same call in another process.  The directory and its
files are removed once every process has mapped every buffer, or failed
to: nothing is left behind, not even by a failed build.

How the stores are ordered against the receivers' reads is the exchanges'
business (:func:`.rdma_exchange.end_sends`).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import tempfile
import weakref

import torch
import torch.distributed as dist

from ..kernels import build
from .mesh import KeyMesh, gather_objects, side_group

SHM_ROOT: str | None = None  # where the CPU plane's directories go (None: tempfile's)


class _DeviceWords:
    """``words`` int32 words of device memory at ``ptr``, for
    ``torch.as_tensor`` (``__cuda_array_interface__``).  ``release``, the C
    entry point that frees or unmaps the memory, runs when this object is
    collected, which is after the last tensor over it is dropped."""

    def __init__(self, device: torch.device, ptr: int, words: int, release: str):
        self.__cuda_array_interface__ = {
            "shape": (words,), "typestr": "<i4", "data": (ptr, False),
            "strides": None, "version": 2,
        }
        weakref.finalize(self, _release, release, device.index, ptr).atexit = False


def _release(name: str, device: int, ptr: int) -> None:
    build.check(getattr(build.load(), name)(device, ptr), f"{name} of a receive buffer")


def _alloc(device: torch.device, directory: str | None, name: str, words: int,
           export: bool) -> tuple[torch.Tensor, object]:
    """A new buffer of ``words`` int32 words and its handle (None unless
    ``export``)."""
    if device.type == "cpu":
        path = os.path.join(directory, name)
        return torch.from_file(path, shared=True, size=words, dtype=torch.int32), path
    lib = build.load()
    ptr = ctypes.c_void_p()
    build.check(lib.grs_ipc_alloc(device.index, 4 * words, ctypes.byref(ptr)),
                "cudaMalloc of a receive buffer")
    buf = torch.as_tensor(_DeviceWords(device, ptr.value, words, "grs_ipc_free"))
    if not export:
        return buf, None
    handle = ctypes.create_string_buffer(lib.grs_ipc_handle_bytes())
    build.check(lib.grs_ipc_export(device.index, ptr, handle),
                "cudaIpcGetMemHandle of a receive buffer")
    return buf, handle.raw


def _open(device: torch.device, handle, words: int) -> torch.Tensor:
    """A peer's buffer of ``words`` int32 words, mapped from its handle."""
    if device.type == "cpu":
        if not os.path.isfile(handle):  # from_file would make a new, unshared file
            raise FileNotFoundError(f"no receive buffer at {handle} on this host")
        return torch.from_file(handle, shared=True, size=words, dtype=torch.int32)
    ptr = ctypes.c_void_p()
    build.check(build.load().grs_ipc_open(device.index, ctypes.create_string_buffer(handle),
                                          ctypes.byref(ptr)),
                f"cudaIpcOpenMemHandle of a peer's receive buffer on {device}")
    return torch.as_tensor(_DeviceWords(device, ptr.value, words, "grs_ipc_close"))


class PeerBuffers:
    """The receive buffers of a process-group mesh's rdma exchanges, made
    once for ``n_local`` keys a rank (see the module docstring); every
    process of the group builds it together.  ``local`` holds this
    process's L buffers, ``receivers`` all P in global rank order.
    ``offsets`` places local buffer i that many keys (0-3) past a 16-byte
    boundary (0: the allocation's base); the checks of the exchange
    kernels' unaligned stores use it."""

    def __init__(self, mesh: KeyMesh, n_local: int, *, offsets=None):
        if mesh.group is None:
            raise ValueError("peer buffers serve a process-group mesh; a single controller "
                             "allocates every receive buffer itself")
        L, dev = len(mesh.devices), mesh.devices[0]
        offsets = [0] * L if offsets is None else list(offsets)
        if len(offsets) != L or not all(0 <= o < 4 for o in offsets):
            raise ValueError(f"offsets must be {L} word offsets in [0, 4), got {offsets}")
        W, me = mesh.processes, mesh.first // L
        directory = None
        if dev.type == "cpu":
            directory = tempfile.mkdtemp(prefix=f"grs_peers_{os.getpid()}_", dir=SHM_ROOT)
        try:
            own = [_alloc(dev, directory, f"rank{g}", n_local + off, W > 1)
                   for g, off in zip(mesh.ranks, offsets)]
            mapped = {me: [buf for buf, _ in own]}
            if W > 1:
                side = side_group(mesh.group)
                seen = gather_objects(side, [(h, off) for (_, h), off in zip(own, offsets)])
                error = None
                try:
                    for p, handles in enumerate(seen):
                        if p != me:
                            mapped[p] = [_open(dev, h, n_local + off) for h, off in handles]
                except (OSError, RuntimeError) as e:
                    error = f"process {me}: {e}"
                errors = [e for e in gather_objects(side, error) if e is not None]
                if errors:
                    raise RuntimeError("the processes could not map each other's receive "
                                       "buffers: " + "; ".join(errors))
                offsets_of = {p: [off for _, off in handles] for p, handles in enumerate(seen)}
            else:
                offsets_of = {me: offsets}
        finally:
            if directory is not None:
                shutil.rmtree(directory)
        self.n_local = n_local
        self.receivers = [
            buf[off:off + n_local].view(torch.uint32)
            for p in range(W) for buf, off in zip(mapped[p], offsets_of[p])
        ]
        self.local = self.receivers[mesh.first:mesh.first + L]
        self.device = dev


def drain(mesh: KeyMesh) -> None:
    """After a round's stores, before any receiver reads: every process's
    stores are complete.  Over NCCL one one-word ``all_reduce``, ordered on
    the stream like every collective (no host wait); over gloo, whose
    collectives wait for the card anyway, a synchronise of this process's
    stream and a barrier."""
    dev = mesh.devices[0]
    if dist.get_backend(mesh.group) == "nccl":
        dist.all_reduce(torch.zeros(1, dtype=torch.int32, device=dev), group=mesh.group)
        return
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    dist.barrier(group=mesh.group)
