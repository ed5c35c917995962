"""The key mesh: one controller over a list of devices, or one process of many.

Port of ``gpu_radix_sort_tpu/parallel/mesh.py``'s key mesh.  JAX runs a
``shard_map`` over ``jax.devices()``, one program on every host; here a mesh
takes one of two forms, and a sharded array is a list of tensors, one for
each rank this process holds, shard r on ``devices[r]``.

**Single controller** (``group=None``, :func:`key_mesh`): one process holds
every rank of axis ``"x"`` in a tuple of ``torch.device``s.

  * By default the mesh is every visible CUDA device; with none,
    :func:`key_mesh` raises (a CPU mesh is built only on request).
  * A device may repeat: ``key_mesh([torch.device("cuda", 0)] * 4)`` is four
    ranks on one card, the counterpart of the JAX tests' virtual CPU
    devices, and ``key_mesh([torch.device("cpu")] * P)`` is what the CPU
    tests use.  Ranks on one device share its current stream.
  * :func:`all_gather`, :func:`all_to_all` and :func:`psum` are plain
    functions over the list: copies across devices, no kernel.  Ranks that
    share a device share one gathered copy.

**Process group** (``key_mesh(devices, group=g)``, or
:func:`.multihost.pod_key_mesh`): W processes joined by
``torch.distributed``, torch's own idiom of one process a card.

  * Process p holds L local ranks on one device of its own (``cuda:
    LOCAL_RANK``, or the CPU), listed in ``devices``; every process holds
    the same L.  The global rank of local rank i is ``first + i`` with
    ``first = p * L``, host-major as JAX's ``pod_key_mesh`` orders the
    devices.  ``size`` and ``shape`` are the global P = W * L.  A process
    whose ranks span several cards keeps using the single-controller mesh.
  * Each collective packs the process's L local blocks into one buffer and
    makes one ``torch.distributed`` call over the group: ``all_gather``,
    ``all_to_all_single`` with equal splits (every exchange of the mesh
    sorts is capacity-bounded) or ``all_reduce``; it hands back per-rank
    views on the local device.  Every process must make the same
    collectives in the same order, so nothing branches on local data
    before one.
  * Over NCCL the collectives are ordered on the stream: no host wait.
    NCCL puts no two ranks of one communicator on one device, so
    :func:`key_mesh` exchanges the cards' UUIDs once (over a gloo group,
    before NCCL's first call) and raises a ValueError where two processes
    name the same card.  Ranks of several processes on one card go through
    a gloo group instead: gloo takes no CUDA tensor in ``all_to_all``, so
    the collectives copy to host memory and back, explicitly, which waits
    for the card by nature, and count the bytes in :data:`staged_bytes`.
    The mesh never chooses or switches the backend itself.
  * One-time host exchanges (the cards' UUIDs here, the receive buffers'
    handles of :mod:`.peer_memory`) go over a gloo group of the same
    processes (:func:`side_group`), never through NCCL.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

KEY_AXIS = "x"

staged_bytes = 0  # bytes copied between a card and host memory for gloo collectives


@dataclass(frozen=True)
class KeyMesh:
    """A 1-D mesh: ``devices[r]`` holds local rank r's shard, global rank
    ``first + r`` of ``size``; ``group`` is None on a single controller."""

    devices: tuple[torch.device, ...]
    group: object | None = None
    first: int = 0
    processes: int = 1

    @property
    def shape(self) -> dict[str, int]:
        return {KEY_AXIS: self.size}

    @property
    def size(self) -> int:
        return len(self.devices) * self.processes

    @property
    def ranks(self) -> range:
        """The global ranks this process holds, local rank i at ``first + i``."""
        return range(self.first, self.first + len(self.devices))


@dataclass(frozen=True)
class HostChipMesh:
    """A 2-D (host, chip) layout: ``devices[h][c]`` is chip c of host h."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"host": len(self.devices), "chip": len(self.devices[0])}


def _devices(devices) -> tuple[torch.device, ...]:
    """The given devices, or every visible CUDA device; all CPU or all CUDA,
    each CUDA device with its index."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "key_mesh() spans the CUDA devices and none is available; pass "
                "devices, e.g. key_mesh([torch.device('cpu')] * 8)"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if {d.type for d in devices} not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"a mesh is all CPU or all CUDA devices, got {devices}")
    return tuple(
        torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
        if d.type == "cuda" else d
        for d in devices
    )


def key_mesh(devices=None, *, group=None) -> KeyMesh:
    """1-D mesh over the given devices, or over every visible CUDA device.
    With a ``torch.distributed`` process ``group``, the devices are this
    process's local ranks, all on one device (by default one rank on the
    current CUDA device); every process of the group must call it."""
    if group is None:
        return KeyMesh(_devices(devices))
    if devices is None:
        devices = [torch.device("cuda", torch.cuda.current_device())]
    local = _devices(devices)
    if len(set(local)) != 1:
        raise ValueError(
            f"a process of a process-group mesh holds its ranks on one device, got {local}; "
            "a process whose ranks span several cards uses the single-controller mesh "
            "(group=None)"
        )
    nccl = dist.get_backend(group) == "nccl"
    if nccl and local[0].type != "cuda":
        raise ValueError("an NCCL group's mesh is on CUDA devices; use a gloo group on the CPU")
    seen = _exchange_once(group, (len(local), _card_uuid(local[0]) if nccl else None))
    if {n for n, _ in seen} != {len(local)}:
        raise ValueError(
            f"every process of the group must hold the same number of ranks, got "
            f"{[n for n, _ in seen]}"
        )
    cards = [u for _, u in seen]
    if nccl and None not in cards and len(set(cards)) < len(cards):
        raise ValueError(
            "NCCL puts no two ranks of one communicator on one device, and processes "
            f"{[p for p, u in enumerate(cards) if cards.count(u) > 1]} name the same "
            "card: give each process a card of its own, or join the processes of one "
            "card in a gloo group (its collectives are staged through host memory)"
        )
    return KeyMesh(local, group, dist.get_rank(group) * len(local), dist.get_world_size(group))


def _card_uuid(device: torch.device) -> str | None:
    uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
    return None if uuid is None else str(uuid)


_SIDE_GROUPS: dict = {}  # an NCCL group -> its gloo side group, made once


def side_group(group):
    """A gloo group of ``group``'s processes for one-time host exchanges:
    the group itself where it is gloo, else one made for the purpose the
    first time and kept, so that no such exchange is an NCCL call.  Made
    once: a group made again over the same ranks takes the same name, and
    its rendezvous would read its predecessor's stale keys and hang."""
    if dist.get_backend(group) == "gloo":
        return group
    if group not in _SIDE_GROUPS:
        _SIDE_GROUPS[group] = dist.new_group(dist.get_process_group_ranks(group),
                                             backend="gloo", use_local_synchronization=True)
    return _SIDE_GROUPS[group]


def gather_objects(side, value) -> list:
    """Every process's ``value`` (a picklable object), in process order."""
    seen = [None] * dist.get_world_size(side)
    dist.all_gather_object(seen, value, group=side)
    return seen


def _exchange_once(group, value) -> list:
    """Every process's ``value``, gathered over gloo (:func:`side_group`),
    so that no NCCL call comes before the mesh's checks."""
    return gather_objects(side_group(group), value)


def host_chip_mesh(devices=None, hosts: int | None = None) -> HostChipMesh:
    """2-D (host, chip) layout of the given devices (by default every
    visible CUDA device); ``hosts`` defaults to the world size of the
    default process group, 1 where none is initialised."""
    devices = _devices(devices)
    nhosts = hosts or (dist.get_world_size() if dist.is_initialized() else 1)
    if len(devices) % nhosts:
        raise ValueError(f"{len(devices)} devices not divisible by {nhosts} hosts")
    chips = len(devices) // nhosts
    return HostChipMesh(tuple(devices[h * chips:(h + 1) * chips] for h in range(nhosts)))


def axis_size(mesh: KeyMesh, axis: str = KEY_AXIS) -> int:
    return mesh.shape[axis]


def global_ranks(mesh: KeyMesh | None, local: int) -> tuple[int, int]:
    """(P, the global index of the first local rank) for ``local`` shards:
    the shards alone make the mesh where ``mesh`` is None."""
    return (local, 0) if mesh is None else (mesh.size, mesh.first)


def single_controller(mesh: KeyMesh | None, entry: str, build: str) -> None:
    """Raises where a host entry, which returns the whole output to this
    process, is given a process-group mesh, whose output no process holds."""
    if mesh is not None and mesh.group is not None:
        raise ValueError(
            f"{entry} returns the whole output to one process, which a process-group "
            f"mesh does not hold; call {build} in every process of the group instead"
        )


def shard(x: torch.Tensor, mesh: KeyMesh) -> list[torch.Tensor]:
    """Split a tensor whose leading axis is a multiple of the mesh size into
    equal shards along it (keys, or payload rows), and return this
    process's: global shard ``mesh.first + r`` on local rank r's device."""
    P = mesh.size
    if x.dim() == 0 or x.shape[0] % P:
        raise ValueError(f"cannot split shape {tuple(x.shape)} into {P} equal shards")
    n_local = x.shape[0] // P
    return [
        x[(mesh.first + r) * n_local:(mesh.first + r + 1) * n_local].to(dev)
        for r, dev in enumerate(mesh.devices)
    ]


def unshard(shards: list[torch.Tensor]) -> torch.Tensor:
    """The shards joined in rank order on the first rank's device."""
    dev = shards[0].device
    return torch.cat([s.to(dev) for s in shards])


def _staged(mesh: KeyMesh) -> bool:
    return mesh.devices[0].type == "cuda" and dist.get_backend(mesh.group) != "nccl"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    global staged_bytes
    staged_bytes += x.numel() * x.element_size()
    return x.cpu()


def _to_card(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    global staged_bytes
    staged_bytes += x.numel() * x.element_size()
    return x.to(device)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """The bytes of a contiguous tensor, 1-D: the collectives move bytes, so
    every dtype goes through every backend."""
    return x.reshape(-1).view(torch.uint8)


def all_gather(tensors: list[torch.Tensor], mesh: KeyMesh | None = None) -> list[torch.Tensor]:
    """Rank r gets ``torch.stack`` of every rank's tensor, in global rank
    order, on its device."""
    if mesh is None or mesh.group is None:
        by_device: dict[torch.device, torch.Tensor] = {}
        for t in tensors:
            if t.device not in by_device:
                by_device[t.device] = torch.stack([x.to(t.device) for x in tensors])
        return [by_device[t.device] for t in tensors]
    staged = _staged(mesh)
    local = torch.stack(tensors)
    if staged:
        local = _to_host(local)
    out = local.new_empty((mesh.size, *local.shape[1:]))
    chunks = _bytes(out).view(mesh.processes, -1 if out.numel() else 0)
    dist.all_gather(list(chunks.unbind(0)), _bytes(local), group=mesh.group)
    if staged:
        out = _to_card(out, mesh.devices[0])
    return [out] * len(tensors)


def all_to_all(blocks: list[torch.Tensor], mesh: KeyMesh | None = None) -> list[torch.Tensor]:
    """``blocks[i]`` is local rank i's (P, ...) send buffer, row j for global
    rank j; each rank gets the (P, ...) stack of what every rank sent it,
    in global rank order, on its device."""
    if mesh is None or mesh.group is None:
        return [
            torch.stack([b[j].to(blocks[j].device) for b in blocks])
            for j in range(len(blocks))
        ]
    W, L, staged = mesh.processes, len(blocks), _staged(mesh)
    rest = blocks[0].shape[1:]
    # (W, L_dst, L_src, ...): rows q * L + j of every block go to process q's rank j
    send = torch.stack([b.reshape(W, L, *rest) for b in blocks], dim=2)
    if staged:
        send = _to_host(send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(_bytes(recv), _bytes(send), group=mesh.group)
    if staged:
        recv = _to_card(recv, mesh.devices[0])
    # rank j's rows come from global ranks p * L + i: (L_dst, W, L_src, ...)
    return list(recv.transpose(0, 1).reshape(L, mesh.size, *rest).unbind(0))


def psum(values: list[torch.Tensor], mesh: KeyMesh | None = None) -> torch.Tensor:
    """The sum of every rank's value, on the first local rank's device."""
    dev = values[0].device
    total = torch.stack([v.to(dev) for v in values]).sum(0)
    if mesh is None or mesh.group is None:
        return total
    staged = _staged(mesh)
    if staged:
        total = _to_host(total)
    dist.all_reduce(total, group=mesh.group)
    return _to_card(total, dev) if staged else total
