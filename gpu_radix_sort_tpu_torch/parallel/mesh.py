"""The key mesh: one controller over a list of devices in one process.

Port of ``gpu_radix_sort_tpu/parallel/mesh.py``'s 1-D key mesh.  JAX runs a
``shard_map`` over ``jax.devices()`` from one process; here the same single
controller holds a tuple of ``torch.device``s, one for each rank of axis
``"x"``, and a sharded array is a list of tensors, shard r on rank r's
device.

  * By default the mesh is every visible CUDA device; with none,
    :func:`key_mesh` raises (a CPU mesh is built only on request).
  * A device may repeat: ``key_mesh([torch.device("cuda", 0)] * 4)`` is four
    ranks on one card, the counterpart of the JAX tests' virtual CPU
    devices, and ``key_mesh([torch.device("cpu")] * P)`` is what the CPU
    tests use.  Ranks on one device share its current stream.
  * :func:`all_gather`, :func:`all_to_all` and :func:`psum` are plain
    functions over the list: copies across devices, no kernel.  Ranks that
    share a device share one gathered copy.

The multi-process form over ``torch.distributed`` (NCCL) belongs with
``multihost.py`` and is not ported yet (ROADMAP A6).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

KEY_AXIS = "x"


@dataclass(frozen=True)
class KeyMesh:
    """A 1-D mesh: ``devices[r]`` holds rank r's shard."""

    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {KEY_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def key_mesh(devices=None) -> KeyMesh:
    """1-D mesh over the given devices, or over every visible CUDA device."""
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
    devices = tuple(
        torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
        if d.type == "cuda" else d
        for d in devices
    )
    return KeyMesh(devices)


def axis_size(mesh: KeyMesh, axis: str = KEY_AXIS) -> int:
    return mesh.shape[axis]


def shard(x: torch.Tensor, mesh: KeyMesh) -> list[torch.Tensor]:
    """Split a tensor whose leading axis is a multiple of the mesh size into
    equal shards along it (keys, or payload rows), shard r on rank r's
    device."""
    P = mesh.size
    if x.dim() == 0 or x.shape[0] % P:
        raise ValueError(f"cannot split shape {tuple(x.shape)} into {P} equal shards")
    n_local = x.shape[0] // P
    return [
        x[r * n_local:(r + 1) * n_local].to(dev) for r, dev in enumerate(mesh.devices)
    ]


def unshard(shards: list[torch.Tensor]) -> torch.Tensor:
    """The shards joined in rank order on the first rank's device."""
    dev = shards[0].device
    return torch.cat([s.to(dev) for s in shards])


def all_gather(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Rank r gets ``torch.stack(tensors)`` on its device."""
    by_device: dict[torch.device, torch.Tensor] = {}
    for t in tensors:
        if t.device not in by_device:
            by_device[t.device] = torch.stack([x.to(t.device) for x in tensors])
    return [by_device[t.device] for t in tensors]


def all_to_all(blocks: list[torch.Tensor]) -> list[torch.Tensor]:
    """``blocks[i]`` is rank i's (P, ...) send buffer; rank j gets the (P,
    ...) stack of ``blocks[i][j]`` over i, on its device."""
    return [
        torch.stack([b[j].to(blocks[j].device) for b in blocks])
        for j in range(len(blocks))
    ]


def psum(values: list[torch.Tensor]) -> torch.Tensor:
    """The sum of the ranks' values, on the first rank's device."""
    dev = values[0].device
    return torch.stack([v.to(dev) for v in values]).sum(0)
