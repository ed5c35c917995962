"""Multi-process execution: process-group bring-up and the host-major mesh.

Port of ``gpu_radix_sort_tpu/parallel/multihost.py``.  JAX runs one program
on every host over ``jax.devices()`` and coordinates through
``jax.distributed``; the port runs torch's own idiom, W processes joined by
``torch.distributed``, each holding L ranks of the key mesh on one device of
its own (:class:`.mesh.KeyMesh` with a process group).  The mesh sorts and
the hash aggregate run over it through their ``build_*`` functions, called
in every process (``tests/torch_mp_child.py``); the host entries, which
return the whole output to one process, raise on such a mesh.

  * :func:`initialize_distributed` -- ``torch.distributed`` bring-up from
    arguments or torchrun's environment (idempotent; a no-op when nothing
    names a run).
  * :func:`pod_key_mesh` -- the key mesh over the default group, ordered
    host-major: global rank p * L + i is local rank i of process p, so a
    sorted output's contiguous ranges align with processes.
  * :func:`process_shard_bounds` -- which rows of a global array this
    process owns, for per-process IO.

Transport: NCCL between cards (one process a card); gloo where the
processes share a card, their collectives staged through host memory
(:mod:`.mesh`).  The caller names the backend.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import KeyMesh, key_mesh


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str = "nccl",
) -> bool:
    """Bring up the default ``torch.distributed`` group from the arguments
    or torchrun's environment (``MASTER_ADDR`` and ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` picks the card under NCCL).
    ``coordinator`` is ``host:port`` or an init URL (``tcp://...``,
    ``file://...``).  Returns True if a runtime of more than one process is
    active.  Idempotent; with neither arguments nor environment naming a
    run it initialises nothing and returns False.  ``backend="nccl"``
    needs CUDA; the CPU takes ``backend="gloo"``."""
    if coordinator is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    num_processes = num_processes or _int_env("WORLD_SIZE")
    process_id = process_id if process_id is not None else _int_env("RANK")
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if not coordinator and num_processes is None:
        return False
    if process_id is None and (num_processes or 1) > 1:
        raise ValueError("a run of several processes needs process_id (or RANK)")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend='nccl' needs CUDA devices; on the CPU pass backend='gloo'")
        torch.cuda.set_device(_int_env("LOCAL_RANK") or 0)
    if coordinator and "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=coordinator or "env://",
                            world_size=num_processes or 1, rank=process_id or 0)
    return dist.get_world_size() > 1


def _int_env(name: str) -> int | None:
    raw = os.environ.get(name)
    return int(raw) if raw is not None else None


def pod_key_mesh(devices=None) -> KeyMesh:
    """The 1-D key mesh over the default process group, ordered host-major:
    ``devices`` are this process's local ranks, all on one device (by
    default one rank on ``cuda:LOCAL_RANK``), and global rank p * L + i is
    local rank i of process p.  With no group initialised, the
    single-controller mesh over ``devices`` (by default every CUDA device),
    as JAX's spans ``jax.devices()`` in one process."""
    if not dist.is_initialized():
        return key_mesh(devices)
    if devices is None:
        devices = [torch.device("cuda", _int_env("LOCAL_RANK") or 0)]
    return key_mesh(devices, group=dist.group.WORLD)


def process_shard_bounds(n_global: int, mesh: KeyMesh | None = None) -> tuple[int, int]:
    """[lo, hi) rows of a length-``n_global`` key-sharded array owned by this
    process's ranks under :func:`pod_key_mesh` ordering -- the per-process
    IO range.  Both ends are clamped to the array: with uneven padding a
    tail process's nominal range can start past ``n_global``, and then it
    owns nothing."""
    mesh = mesh if mesh is not None else pod_key_mesh()
    per_chip = -(-n_global // mesh.size)
    lo = min(mesh.first * per_chip, n_global)
    hi = min((mesh.first + len(mesh.devices)) * per_chip, n_global)
    return (lo, max(hi, lo))
