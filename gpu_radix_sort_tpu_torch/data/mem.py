"""In-process memory backend for DistribArray.

Port of ``gpu_radix_sort_tpu/data/mem.py`` (host code, kept as it is but
for one copy fewer in a range read).

Reference analog: benchmark/pkg/data/mem.go — partitions as in-process byte
buffers, registered in a registry map so ``open`` by name works across
"workers" sharing the process (mem.go:21,84-114).  Used as the fast backend
for single-process distributed sorts and as the fake cluster in tests
(SURVEY.md §4 fixture pattern 3).

Unlike the reference's single global map, registries here are per-factory by
default (test isolation); pass ``registry=GLOBAL_REGISTRY`` or share one
factory to get the reference's process-global open-by-name behavior.
"""

from __future__ import annotations

import threading
import weakref

from .interface import (
    ArrayFactory,
    CapacityError,
    DistribArray,
    DistribArrayShape,
    PartReader,
    PartWriter,
)


class MemRegistry(dict):
    """A name->array registry.  A dict subclass so it is weakref-able:
    per-registry locks live in a WeakKeyDictionary side table whose entries
    die exactly with the registry (plain ``dict`` cannot be weakly
    referenced, which is why sharing a plain dict falls back to an in-dict
    reserved key — see MemArrayFactory)."""


# Opt-in process-global registry (the reference's `arrays` map, mem.go:21).
GLOBAL_REGISTRY: MemRegistry = MemRegistry()


class _MemPartReader(PartReader):
    def __init__(self, buf: bytes):
        self._buf = buf
        self._pos = 0

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = len(self._buf) - self._pos
        out = self._buf[self._pos : self._pos + n]
        self._pos += len(out)
        return out


class _MemPartWriter(PartWriter):
    def __init__(self, arr: "MemDistribArray", part_idx: int):
        self._arr = arr
        self._idx = part_idx

    def write(self, data: bytes) -> int:
        return self._arr._append(self._idx, data)


class MemDistribArray(DistribArray):
    def __init__(self, name: str, shape: DistribArrayShape):
        self._name = name
        self._caps = shape.caps
        self._parts = [bytearray() for _ in range(shape.npart)]
        for i in range(shape.npart):
            if shape.len(i):
                raise ValueError("memory arrays are created empty")
        self._lock = threading.Lock()
        self._destroyed = False

    @property
    def name(self) -> str:
        return self._name

    def _check_alive(self) -> None:
        if self._destroyed:
            raise IOError(f"array {self._name!r} has been destroyed")

    def _append(self, idx: int, data: bytes) -> int:
        with self._lock:
            self._check_alive()
            part = self._parts[idx]
            if len(part) + len(data) > self._caps[idx]:
                raise CapacityError(
                    f"{self._name}[{idx}]: write of {len(data)} bytes exceeds "
                    f"cap {self._caps[idx]} (len {len(part)})"
                )
            part.extend(data)
            return len(data)

    def get_shape(self) -> DistribArrayShape:
        with self._lock:
            self._check_alive()
            return DistribArrayShape([len(p) for p in self._parts], self._caps)

    def get_part_reader(self, part_idx: int) -> PartReader:
        with self._lock:
            self._check_alive()
            return _MemPartReader(bytes(self._parts[part_idx]))

    def get_part_range_reader(self, part_idx, start, end) -> PartReader:
        with self._lock:
            self._check_alive()
            ln = len(self._parts[part_idx])
            if end <= 0:
                end = ln + end
            if start < 0 or end < start or end > ln:
                raise ValueError(
                    f"{self._name}[{part_idx}]: range [{start}, {end}) out of "
                    f"committed len {ln}"
                )
            # one copy: a bytearray slice would copy before bytes() does
            with memoryview(self._parts[part_idx]) as view:
                return _MemPartReader(bytes(view[start:end]))

    def get_part_writer(self, part_idx: int) -> PartWriter:
        self._check_alive()
        return _MemPartWriter(self, part_idx)

    def close(self) -> None:
        pass  # memory writes are immediately committed

    def destroy(self) -> None:
        with self._lock:
            self._destroyed = True
            self._parts = []
        self._on_destroy()

    def _on_destroy(self) -> None:  # wired by the factory
        pass


class MemArrayFactory(ArrayFactory):
    """Factory over a (shared or private) name registry
    (reference: MemArrayFactory, mem.go:84-114)."""

    # One lock PER REGISTRY OBJECT, not per factory: two factories sharing
    # one registry must synchronize on the same lock or concurrent create()
    # of the same name can silently overwrite instead of raising
    # FileExistsError.  Weakref-able registries (MemRegistry, the default
    # GLOBAL_REGISTRY) get their lock from a WeakKeyDictionary side table
    # whose entry dies exactly with the registry — no pollution of the
    # user's mapping, no id-keyed leak/alias.  A shared PLAIN dict cannot
    # be weakly referenced, so there the lock lives inside the dict under a
    # reserved key (dict.setdefault is atomic in CPython) and iterating
    # such a registry will see that entry.
    _LOCK_KEY = "\x00__registry_lock__"
    _locks: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
    _locks_guard = threading.Lock()

    def __init__(self, registry: dict | None = None):
        if registry is None:
            # private registry: nobody else can hold this dict, so a
            # per-factory lock suffices
            self._registry = MemRegistry()
            self._lock = threading.Lock()
            return
        self._registry = registry
        try:
            with MemArrayFactory._locks_guard:
                lock = MemArrayFactory._locks.get(registry)
                if lock is None:
                    lock = threading.Lock()
                    MemArrayFactory._locks[registry] = lock
            self._lock = lock
        except TypeError:  # plain dict: not weakref-able
            self._lock = registry.setdefault(
                MemArrayFactory._LOCK_KEY, threading.Lock()
            )

    def create(self, name: str, shape: DistribArrayShape) -> DistribArray:
        if name == MemArrayFactory._LOCK_KEY:
            raise ValueError("reserved registry key")
        arr = MemDistribArray(name, shape)
        with self._lock:
            if name in self._registry:
                raise FileExistsError(f"memory array {name!r} already exists")
            self._registry[name] = arr

        def _on_destroy(reg=self._registry, lock=self._lock, nm=name, a=arr):
            with lock:
                if reg.get(nm) is a:
                    del reg[nm]

        arr._on_destroy = _on_destroy
        return arr

    def open(self, name: str) -> DistribArray:
        if name == MemArrayFactory._LOCK_KEY:
            raise FileNotFoundError(f"no memory array named {name!r}")
        with self._lock:
            try:
                return self._registry[name]
            except KeyError:
                raise FileNotFoundError(f"no memory array named {name!r}") from None
