"""Device-resident backend for DistribArray.

Port of ``gpu_radix_sort_tpu/data/device.py``.  The GPU reference always
round-trips bucket data through host storage (mem.go / file.go) between
rounds, paying host-to-device and device-to-host copies each round (~46% of
its partial-sort GPU time, SURVEY.md §3).  This backend keeps each partition
as a 1-D ``torch.uint8`` tensor on the card, so the storage round loop
(parallel/storage_sort.py) runs its rounds without moving keys to the host
until the final linearization.

Semantics match the other backends (append-only fixed-cap partitions,
single writer, commit on close); appends stage in a host buffer and move to
the device on ``close()`` (one copy a partition, not one a write).  Readers
slice on the device and copy bytes to the host only when ``read`` is called;
``device_range`` / ``device_slice`` hand out the device views themselves for
consumers that stay on the device.

A committed partition is immutable.  The views handed out share storage with
the committed tensors (a packed commit's partitions are views of one
backing), so no consumer writes into them: every operation of the round
loops on them makes a new tensor.

``DeviceArrayFactory()`` puts its arrays on the CUDA device and raises when
there is none; the CPU is used only when ``device="cpu"`` is passed.
"""

from __future__ import annotations

import threading

import torch

from .interface import (
    ArrayFactory,
    CapacityError,
    DistribArray,
    DistribArrayShape,
    PartReader,
    PartWriter,
)


def resolve_device(device=None) -> torch.device:
    """The device an entry point of the storage plane works on: the CUDA
    device unless the caller names another; raises when CUDA is asked for
    (or implied) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the storage plane runs on the CUDA device and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class _DevicePartReader(PartReader):
    def __init__(self, dev_part: torch.Tensor, start: int, nbyte: int):
        self._dev = dev_part
        self._pos = start
        self._end = start + nbyte

    def read(self, n: int = -1) -> bytes:
        avail = self._end - self._pos
        if n is None or n < 0 or n > avail:
            n = avail
        if n == 0:
            return b""
        chunk = self._dev[self._pos : self._pos + n].cpu()
        self._pos += n
        return chunk.numpy().tobytes()


class _DevicePartWriter(PartWriter):
    def __init__(self, arr: "DeviceDistribArray", part_idx: int):
        self._arr = arr
        self._idx = part_idx

    def write(self, data: bytes) -> int:
        return self._arr._append(self._idx, data)


class DeviceDistribArray(DistribArray):
    device_native = True  # capability flag: zero-copy device commit/fetch

    def __init__(self, name: str, shape: DistribArrayShape, device=None):
        self._name = name
        self._caps = shape.caps
        self._device = resolve_device(device)
        self._dev_parts: list = [None] * shape.npart  # committed device data
        # Packed commit path: one u8 backing tensor + per-partition offsets
        # (zero per-partition device ops at commit time).
        self._backing: torch.Tensor | None = None
        self._offsets: list[int] | None = None
        self._lens = [0] * shape.npart  # committed lengths
        self._pending: list[bytearray] = [bytearray() for _ in range(shape.npart)]
        self._lock = threading.Lock()
        self._destroyed = False

    @property
    def name(self) -> str:
        return self._name

    @property
    def device(self) -> torch.device:
        return self._device

    def _check_alive(self) -> None:
        if self._destroyed:
            raise IOError(f"array {self._name!r} has been destroyed")

    def _check_tensor(self, t: torch.Tensor, what: str) -> None:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8 or t.dim() != 1:
            raise ValueError(f"{what} must be a 1-D torch.uint8 tensor")
        if not _same_device(t.device, self._device):
            raise ValueError(f"{what} is on {t.device}, the array on {self._device}")

    def _append(self, idx: int, data: bytes) -> int:
        with self._lock:
            self._check_alive()
            if self._backing is not None:
                raise IOError(
                    f"{self._name}[{idx}]: array committed via "
                    "put_device_packed; partitions are immutable"
                )
            total = self._lens[idx] + len(self._pending[idx]) + len(data)
            if total > self._caps[idx]:
                raise CapacityError(
                    f"{self._name}[{idx}]: write of {len(data)} bytes exceeds "
                    f"cap {self._caps[idx]}"
                )
            self._pending[idx].extend(data)
            return len(data)

    def put_device_part(self, idx: int, dev_array: torch.Tensor) -> None:
        """Commit a 1-D uint8 tensor already on the array's device as
        partition ``idx``'s content: the write path with no host copy.  The
        array keeps the tensor; the caller must not write into it after."""
        with self._lock:
            self._check_alive()
            if self._backing is not None:
                # a per-part commit after a packed commit would be shadowed
                # by the backing in _part_view: served as ANOTHER
                # partition's bytes, silently
                raise IOError(
                    f"{self._name}[{idx}]: array committed via "
                    "put_device_packed; partitions are immutable"
                )
            if (
                self._lens[idx]
                or self._pending[idx]
                or self._dev_parts[idx] is not None  # zero-length commit
            ):
                raise IOError(f"{self._name}[{idx}]: partition already written")
            self._check_tensor(dev_array, "device part")
            if dev_array.shape[0] > self._caps[idx]:
                raise CapacityError(
                    f"{self._name}[{idx}]: {dev_array.shape[0]} bytes exceeds "
                    f"cap {self._caps[idx]}"
                )
            self._dev_parts[idx] = dev_array
            self._lens[idx] = int(dev_array.shape[0])

    def put_device_packed(self, backing: torch.Tensor, lens) -> None:
        """Commit ALL partitions at once as views of one uint8 ``backing``
        tensor on the array's device (partition d = backing[sum(lens[:d]) :
        +lens[d]]): the commit of the device round loops, with no host copy
        and no device operation a partition.  The array keeps the backing;
        the caller must not write into it after."""
        lens = [int(x) for x in lens]
        with self._lock:
            self._check_alive()
            if (
                any(self._lens)
                or any(self._pending)
                or self._backing is not None
                or any(p is not None for p in self._dev_parts)
            ):
                raise IOError(f"{self._name}: array already written")
            if len(lens) != len(self._caps):
                raise ValueError(
                    f"{self._name}: {len(lens)} lens for {len(self._caps)} parts"
                )
            self._check_tensor(backing, "backing")
            if sum(lens) != int(backing.shape[0]):
                raise ValueError(
                    f"{self._name}: lens sum {sum(lens)} != backing "
                    f"{backing.shape[0]}"
                )
            for d, (ln, cap) in enumerate(zip(lens, self._caps)):
                if ln > cap:
                    raise CapacityError(
                        f"{self._name}[{d}]: {ln} bytes exceeds cap {cap}"
                    )
            offs, pos = [], 0
            for ln in lens:
                offs.append(pos)
                pos += ln
            self._backing = backing
            self._offsets = offs
            self._lens = lens

    def _part_view(self, idx: int):
        """Committed u8 device data of a partition (None when empty/unset);
        packed arrays slice the backing (a view)."""
        if self._backing is not None:
            ln = self._lens[idx]
            if not ln:
                return None
            o = self._offsets[idx]
            return self._backing[o : o + ln]
        return self._dev_parts[idx]

    def device_range(self, idx: int, start: int = 0, nbyte: int = -1) -> torch.Tensor:
        """u8 device view of partition bytes [start, start+nbyte) (nbyte < 0:
        to the end): the fetch path with no host copy.  A view of committed
        data: read it, never write into it."""
        with self._lock:
            self._check_alive()
            ln = self._lens[idx]
            if nbyte < 0:
                nbyte = ln - start
            if start < 0 or nbyte < 0 or start + nbyte > ln:
                raise ValueError(
                    f"{self._name}[{idx}]: range [{start}, {start + nbyte}) "
                    f"out of committed len {ln}"
                )
            if self._backing is not None:
                o = self._offsets[idx] + start
                return self._backing[o : o + nbyte]
            if self._dev_parts[idx] is None:
                return torch.zeros((0,), dtype=torch.uint8, device=self._device)
            return self._dev_parts[idx][start : start + nbyte]

    def device_slice(self, idx: int):
        """The committed device tensor of a partition (uint8[len]), or None
        when it is empty or unset."""
        with self._lock:
            self._check_alive()
            return self._part_view(idx)

    def _flush(self) -> None:
        for idx in range(len(self._caps)):
            pend = self._pending[idx]
            if not pend:
                continue
            new = torch.frombuffer(pend, dtype=torch.uint8).to(self._device, copy=True)
            old = self._dev_parts[idx]
            if old is not None:
                new = torch.cat([old, new])
            self._dev_parts[idx] = new
            self._lens[idx] += len(pend)
            self._pending[idx] = bytearray()

    def get_shape(self) -> DistribArrayShape:
        with self._lock:
            self._check_alive()
            return DistribArrayShape(list(self._lens), self._caps)

    def get_part_reader(self, part_idx: int) -> PartReader:
        with self._lock:
            self._check_alive()
            dev = self._part_view(part_idx)
            ln = self._lens[part_idx]
        if dev is None:
            return _EmptyReader()
        return _DevicePartReader(dev, 0, ln)

    def get_part_range_reader(self, part_idx, start, end) -> PartReader:
        with self._lock:
            self._check_alive()
            dev = self._part_view(part_idx)
            ln = self._lens[part_idx]
        if end <= 0:
            end = ln + end
        if start < 0 or end < start or end > ln:
            raise ValueError(
                f"{self._name}[{part_idx}]: range [{start}, {end}) out of "
                f"committed len {ln}"
            )
        if dev is None:
            return _EmptyReader()
        return _DevicePartReader(dev, start, end - start)

    def get_part_writer(self, part_idx: int) -> PartWriter:
        self._check_alive()
        return _DevicePartWriter(self, part_idx)

    def close(self) -> None:
        with self._lock:
            self._check_alive()
            self._flush()

    def destroy(self) -> None:
        with self._lock:
            self._destroyed = True
            self._dev_parts = []
            self._pending = []
            self._backing = None
            self._offsets = None
        self._on_destroy()

    def _on_destroy(self) -> None:  # wired by the factory
        pass


class _EmptyReader(PartReader):
    def read(self, n: int = -1) -> bytes:
        return b""


class DeviceArrayFactory(ArrayFactory):
    """Factory keeping partitions in device memory; registry-based
    open-by-name like the memory backend.  ``device``: the CUDA device by
    default (raises when there is none); ``"cpu"`` only when asked for."""

    device_native = True  # round loops may use the zero-copy device path

    def __init__(self, device=None, registry: dict | None = None):
        self._device = resolve_device(device)
        self._registry: dict[str, DeviceDistribArray] = (
            registry if registry is not None else {}
        )
        self._lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        return self._device

    def create(self, name: str, shape: DistribArrayShape) -> DistribArray:
        arr = DeviceDistribArray(name, shape, device=self._device)
        with self._lock:
            if name in self._registry:
                raise FileExistsError(f"device array {name!r} already exists")
            self._registry[name] = arr

        def _on_destroy(reg=self._registry, lock=self._lock, nm=name, a=arr):
            with lock:
                if reg.get(nm) is a:
                    del reg[nm]

        arr._on_destroy = _on_destroy
        return arr

    def open(self, name: str) -> DistribArray:
        with self._lock:
            try:
                return self._registry[name]
            except KeyError:
                raise FileNotFoundError(f"no device array named {name!r}") from None
