"""Distributed LSD radix sort over the key mesh.

Port of ``gpu_radix_sort_tpu/parallel/distributed.py``: the reference's
bulk-synchronous rounds (benchmark/pkg/sort/distrib.go:90-248, ``nstep =
32/width``, each a local partial sort and a bucket repartition) over the
mesh of :mod:`.mesh`, a single controller or a process group.  Round
invariant: after round r the global array (shard-major) is sorted by bits
[0, (r+1)*width).

Two loops, as in JAX:
  * unfused (:func:`_round_fn` each round): the stable local digit sort,
    the exchange, the stable reassembly;
  * fused (default for ``alltoall``, ``overflow`` and ``rdma``,
    :func:`_fused_sort_shard`): nsteps + 1 keys-only ``sort_full`` calls of
    ``rotr32``-rotated keys around the raw exchanges; slack slots
    (``tags == D``) become 0xFFFFFFFF before the next sort.  The output is
    bit-identical to the unfused loop's.

Exchanges: ``gather``, ``alltoall`` and ``overflow`` (:mod:`.exchange`);
``rdma`` (B6, :mod:`.rdma_exchange`) and ``rdma_overlap`` (B7,
:mod:`.rdma_overlap`), whose receive buffers are exact, so ``rdma`` takes
any n_local (no 128-lane rounding); the last two store into the peers'
receive buffers: on a process-group mesh those of other processes, mapped
once when the sort is built (:class:`.peer_memory.PeerBuffers`).
Strategies are the port's own: ``"auto"`` runs the kernels, ``"torch"``
runs ``torch.sort`` (JAX's ``"xla"``); JAX's ``"pallas_radix"`` has no
counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bits import KEY_BITS, KEY_DTYPE, decode_ordered, encode_ordered, rotr32
from ..ops.radix_sort import _VALID as _VALID_STRATEGY
from ..ops.radix_sort import sort_full
from ..utils.timers import span
from . import exchange as ex
from . import rdma_overlap as ov
from .mesh import KEY_AXIS, KeyMesh, key_mesh, psum, shard, single_controller, unshard
from .peer_memory import PeerBuffers
from .rdma_exchange import exchange_round_rdma, exchange_round_rdma_raw

_VALID_EXCHANGE = (
    "auto", "alltoall", "overflow", "gather", "rdma", "rdma_overlap"
)
_FUSABLE = ("alltoall", "overflow", "rdma")
_PEER_MEMORY = ("rdma", "rdma_overlap")


def _round_fn(shards, *, offset, width, exchange, capacity, strategy, mesh=None, peers=None):
    """One unfused round: returns (new shards, overflowed per rank)."""
    if exchange == "gather":
        return ex.exchange_round_gather(shards, offset, width, strategy=strategy, mesh=mesh)
    if exchange == "overflow":
        c0, c_ov = capacity
        return ex.exchange_round_alltoall_overflow(
            shards, offset, width, c0, c_ov, strategy=strategy, mesh=mesh
        )
    if exchange == "rdma":
        return exchange_round_rdma(shards, offset, width, strategy=strategy, mesh=mesh,
                                   peers=peers)
    if exchange == "rdma_overlap":
        return ov.exchange_round_rdma_overlapped(
            shards, offset, width, tile=capacity, strategy=strategy, mesh=mesh, peers=peers
        )
    return ex.exchange_round_alltoall(
        shards, offset, width, capacity, strategy=strategy, mesh=mesh
    )


def _exchange_raw(sorted_shards, *, offset, width, exchange, capacity, mesh=None, peers=None):
    """Round k's exchange of already digit-sorted shards without the
    reassembly: lists (tags, flat, overflowed), see
    ``exchange.exchange_round_alltoall_raw``."""
    with span("grs.exchange"):
        if exchange == "overflow":
            c0, c_ov = capacity
            return ex.exchange_round_alltoall_overflow_raw(
                sorted_shards, offset, width, c0, c_ov, mesh
            )
        if exchange == "rdma":
            return exchange_round_rdma_raw(sorted_shards, offset, width, mesh, peers)
        return ex.exchange_round_alltoall_raw(sorted_shards, offset, width, capacity, mesh)


def _unslack(tags: torch.Tensor, z: torch.Tensor, width: int) -> torch.Tensor:
    """z with 0xFFFFFFFF on the slack slots (``tags == D``)."""
    slack = tags.view(torch.int32) == (1 << width)
    return torch.where(slack, -1, z.view(torch.int32)).view(KEY_DTYPE)


def _fused_sort_shard(shards, *, width, exchange, capacity, strategy, nsteps, mesh=None,
                      peers=None):
    """LSD loop where every round is ONE keys-only full sort of a
    bit-rotated key: round k's shard order (digit_k, bits [0, k*width),
    high bits) is the plain ascending order of rotr(x, (k+1)*width), a pure
    value function (the JAX docstring has the induction).  A slack slot
    forced to 0xFFFFFFFF can only tie with a real 0xFFFFFFFF rotated key of
    the same value, so the first n_local survivors are exact."""
    n_local = shards[0].numel()
    overflow = [torch.zeros((), dtype=torch.int32, device=s.device) for s in shards]
    tags = flat = None
    for step in range(nsteps):
        with span("grs.round"):
            if step == 0:
                sorted_shards = [
                    rotr32(sort_full(rotr32(s, width), strategy=strategy), 32 - width)
                    for s in shards
                ]
            else:
                rot = ((step + 1) * width) % 32
                sorted_shards = [
                    rotr32(sort_full(_unslack(t, rotr32(f, rot), width),
                                     strategy=strategy), 32 - rot)[:n_local]
                    for t, f in zip(tags, flat)
                ]
            tags, flat, ovf = _exchange_raw(
                sorted_shards, offset=step * width, width=width,
                exchange=exchange, capacity=capacity, mesh=mesh, peers=peers,
            )
            overflow = [o + v.to(torch.int32) for o, v in zip(overflow, ovf)]
    # the final round's rotation is the identity: a plain value sort reassembles
    with span("grs.round"):
        out = [
            sort_full(_unslack(t, f, width), strategy=strategy)[:n_local]
            for t, f in zip(tags, flat)
        ]
    return out, psum(overflow, mesh)


def build_distributed_sort(
    mesh: KeyMesh,
    n_local: int,
    *,
    width: int = 8,
    exchange: str = "auto",
    capacity_factor: float = 1.25,
    strategy: str | None = None,
    axis: str = KEY_AXIS,
    overlap_tile: int | None = None,
    fuse_rounds: bool | None = None,
):
    """The distributed full sort of P shards of ``n_local`` keys.

    Returns ``fn(shards) -> (sorted shards, overflow count)``: ``shards`` a
    list of this process's 1-D uint32 shards, shard r on
    ``mesh.devices[r]`` (all P on a single controller), the count an int
    scalar on the first rank's device (ranks x rounds that overflowed a
    capacity, summed over the whole mesh).  ``fuse_rounds`` (default: on
    for alltoall, overflow and rdma) runs :func:`_fused_sort_shard`; the
    output is bit-identical either way.  ``"rdma"`` and ``"rdma_overlap"``
    store into the peers' receive buffers: on a process-group mesh the
    build allocates this process's, maps the other processes' (CUDA IPC;
    shared memory on the CPU) and keeps them for every call, so every
    process of the group builds together, and raises where a mapping
    fails."""
    if KEY_BITS % width or width > 16:
        # width=32 would need 2^32 digit-count bins and a sentinel digit
        # beyond uint32 -- use sort_full on one device.
        raise ValueError(f"width {width} must divide {KEY_BITS} and be <= 16")
    if exchange not in _VALID_EXCHANGE:
        raise ValueError(f"exchange must be one of {_VALID_EXCHANGE}")
    if strategy is not None and strategy not in _VALID_STRATEGY:
        raise ValueError(f"strategy must be one of {_VALID_STRATEGY}, got {strategy!r}")
    nchips = mesh.shape[axis]
    if exchange == "auto":
        # gather is exact and fastest for small shards; alltoall scales.
        exchange = "gather" if n_local * nchips <= (1 << 20) else "alltoall"
    if exchange == "overflow":
        capacity = ex.overflow_capacities(n_local, nchips)
    elif exchange == "rdma":
        capacity = None
    elif exchange == "rdma_overlap":
        if width > ov.MAX_WIDTH:
            raise ValueError(
                f"exchange='rdma_overlap' supports width <= {ov.MAX_WIDTH}"
            )
        capacity = overlap_tile or ov.pick_tile(n_local)  # group tile size
    else:
        capacity = ex.default_capacity(n_local, nchips, capacity_factor)
    nsteps = KEY_BITS // width
    if fuse_rounds is None:
        fuse_rounds = exchange in _FUSABLE
    elif fuse_rounds and exchange not in _FUSABLE:
        raise ValueError(
            "fuse_rounds requires exchange in ('alltoall', 'overflow', "
            f"'rdma'); got exchange={exchange!r}"
        )
    peers = None
    if mesh.group is not None and exchange in _PEER_MEMORY:
        peers = PeerBuffers(mesh, n_local)

    def fn(shards):
        shards = list(shards)
        if len(shards) != len(mesh.devices) or any(
            s.numel() != n_local or s.device != d for s, d in zip(shards, mesh.devices)
        ):
            raise ValueError(
                f"expected {len(mesh.devices)} shards of {n_local} keys on {mesh.devices}"
            )
        with span("grs.mesh_sort"):
            if fuse_rounds:
                return _fused_sort_shard(
                    shards, width=width, exchange=exchange, capacity=capacity,
                    strategy=strategy, nsteps=nsteps, mesh=mesh, peers=peers,
                )
            overflow = [torch.zeros((), dtype=torch.int32, device=s.device) for s in shards]
            for step in range(nsteps):
                with span("grs.round"):
                    shards, ovf = _round_fn(
                        shards, offset=step * width, width=width, exchange=exchange,
                        capacity=capacity, strategy=strategy, mesh=mesh, peers=peers,
                    )
                    overflow = [o + v.to(torch.int32) for o, v in zip(overflow, ovf)]
            return shards, psum(overflow, mesh)

    return fn


class OverflowError_(RuntimeError):
    pass


def _as_keys(keys) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        return keys.reshape(-1)
    a = np.asarray(keys)
    if a.dtype not in (np.int32, np.float32):
        a = a.astype(np.uint32, copy=False)
    return torch.from_numpy(np.ascontiguousarray(a).reshape(-1))


def sort_distributed(
    keys,
    *,
    mesh: KeyMesh | None = None,
    width: int = 8,
    exchange: str = "auto",
    capacity_factor: float = 1.25,
    strategy: str | None = None,
) -> torch.Tensor:
    """Distributed full sort (reference: SortDistribFromRaw,
    distrib.go:183-248): pads to the mesh with 0xFFFFFFFF, shards, runs
    32/width rounds, returns the linear sorted keys on the mesh's first
    device.  ``keys`` is a numpy array or a tensor; the mesh (by default
    every CUDA device, :func:`.mesh.key_mesh`) decides where it sorts.

    Raises :class:`OverflowError_` if a capacity-bounded exchange overflowed
    (use a larger ``capacity_factor``, ``"gather"`` or ``"rdma"``); under
    ``"auto"`` it falls back to the exact ``"gather"`` exchange instead.
    int32 / float32 keys go through the order-preserving uint32 codec.  On a
    process-group mesh it raises: call :func:`build_distributed_sort`'s
    function in every process."""
    single_controller(mesh, "sort_distributed", "build_distributed_sort")
    keys = _as_keys(keys)
    if keys.dtype in (torch.int32, torch.float32):
        out = sort_distributed(
            encode_ordered(keys), mesh=mesh, width=width, exchange=exchange,
            capacity_factor=capacity_factor, strategy=strategy,
        )
        return decode_ordered(out, keys.dtype)
    if keys.dtype != KEY_DTYPE:
        raise TypeError(f"unsupported key dtype {keys.dtype}; use uint32/int32/float32")
    mesh = mesh or key_mesh()
    nchips = mesh.shape[KEY_AXIS]
    n = keys.numel()
    n_local = max(-(-n // nchips), 1)
    if exchange == "rdma_overlap":
        n_local = -(-n_local // ov.GRAIN) * ov.GRAIN  # a power-of-two tile divides it
    pad = n_local * nchips - n
    padded = keys.view(torch.int32)
    if pad:
        fill = torch.full((pad,), -1, dtype=torch.int32, device=keys.device)
        padded = torch.cat([padded, fill])
    shards = [s.view(KEY_DTYPE) for s in shard(padded, mesh)]
    fn = build_distributed_sort(
        mesh, n_local, width=width, exchange=exchange,
        capacity_factor=capacity_factor, strategy=strategy,
    )
    out, overflow = fn(shards)
    overflow = int(overflow)
    if overflow > 0:
        # Degenerate distributions (all-equal keys: every shard goes to one
        # peer) exceed any fixed per-peer capacity.  "auto" falls back to the
        # exact gather exchange; an explicit alltoall reports the overflow.
        if exchange != "auto":
            raise OverflowError_(
                f"all-to-all capacity overflowed in {overflow} round-chips; "
                "increase capacity_factor or use exchange='gather'"
            )
        fn = build_distributed_sort(
            mesh, n_local, width=width, exchange="gather", strategy=strategy,
        )
        out, overflow = fn(shards)
        assert int(overflow) == 0
    return unshard([s.view(torch.int32) for s in out])[:n].view(KEY_DTYPE)
