"""DistribArray: the storage abstraction of the distributed data plane.

Port of ``gpu_radix_sort_tpu/data/interface.py`` (host code, kept as it is).

Capability mirror of the reference's Go interface (benchmark/pkg/data/
interface.go:9-112) and its Python mirror (faasTest/pylibsort/data.py:34-245):
a *named* array of append-only, fixed-capacity partitions, plus byte-range
references (PartRef) that let orchestration pass data by reference rather
than by value ("The host never explicitly interacts with the raw data, only
passing references", benchmark/README.md:33-35).

Consistency contract (reference: interface.go:64-99, kept verbatim in
spirit):

  * Partitions are append-only; a partition's capacity is fixed at creation.
  * Single writer per partition at a time; concurrent readers are safe
    (backends give each reader independent state/handles, file.go:214-216).
  * ``close()`` commits: data written before close is visible to readers
    obtained afterwards, including via ``factory.open(name)`` from another
    thread or process (file backend).
  * ``destroy()`` releases all storage; the name becomes reusable.

Unit convention: the data plane speaks **bytes** everywhere (PartRef.start /
PartRef.nbyte, reader ranges, shape lens/caps).  The sort APIs speak
elements; conversion happens at the orchestration edge only — the reference
mixes the two per layer (elements at the C ABI libsort.h:19, bytes in Go
libsort.go:58-60, elements in Python sort.py:126), a known trap SURVEY.md §7
says to fix by picking one canonical unit.

Range-reader convention: ``end <= 0`` is interpreted relative to the
partition's committed **length** (end + len).  The reference's two backends
silently disagree here (mem.go:121-127 uses cap, file.go:225-229 uses len);
this framework standardizes on len and tests all backends against it.
"""

from __future__ import annotations

import abc
from typing import Iterator, NamedTuple, Sequence


class CapacityError(IOError):
    """A partition write exceeded its fixed capacity (reference: the mem
    backend's io.EOF on overflow, mem.go:38-53)."""


class DistribArrayShape:
    """Lengths and capacities (bytes) of an array's partitions.

    Reference: DistribArrayShape with private lens/caps and accessor methods
    (interface.go:9-46).  Immutable from the caller's perspective; backends
    produce fresh snapshots from their committed state.
    """

    __slots__ = ("_lens", "_caps")

    def __init__(self, lens: Sequence[int], caps: Sequence[int]):
        if len(lens) != len(caps):
            raise ValueError(f"lens/caps length mismatch: {len(lens)} vs {len(caps)}")
        if len(lens) > 1024:
            # Vectorized validation: width-16 rounds build 65,536-partition
            # shapes per worker; the per-element Python loop was the
            # dominant metadata cost (~0.4s per 8 shapes, profiled).
            import numpy as np

            la = np.asarray(lens, dtype=np.int64)
            ca = np.asarray(caps, dtype=np.int64)
            bad = (la < 0) | (ca < 0) | (la > ca)
            if bad.any():
                i = int(np.argmax(bad))
                raise ValueError(
                    f"partition {i}: invalid len={la[i]} cap={ca[i]}"
                )
            self._lens = tuple(la.tolist())
            self._caps = tuple(ca.tolist())
            return
        for i, (ln, cp) in enumerate(zip(lens, caps)):
            if ln < 0 or cp < 0 or ln > cp:
                raise ValueError(f"partition {i}: invalid len={ln} cap={cp}")
        self._lens = tuple(int(x) for x in lens)
        self._caps = tuple(int(x) for x in caps)

    @property
    def npart(self) -> int:
        return len(self._lens)

    def len(self, idx: int) -> int:
        return self._lens[idx]

    def cap(self, idx: int) -> int:
        return self._caps[idx]

    @property
    def lens(self) -> tuple[int, ...]:
        return self._lens

    @property
    def caps(self) -> tuple[int, ...]:
        return self._caps

    def starts(self) -> tuple[int, ...]:
        """Byte offset of each partition in a contiguous concatenation of
        capacities (the file backend's layout, file.go:146-160; mirrored by
        pylibsort ArrayShape.starts, data.py:44-52)."""
        if len(self._caps) > 1024:
            import numpy as np

            c = np.asarray(self._caps, dtype=np.int64)
            return tuple((np.cumsum(c) - c).tolist())
        out, acc = [], 0
        for c in self._caps:
            out.append(acc)
            acc += c
        return tuple(out)

    def total_cap(self) -> int:
        return sum(self._caps)

    def total_len(self) -> int:
        return sum(self._lens)

    def __repr__(self) -> str:
        return f"DistribArrayShape(lens={self._lens}, caps={self._caps})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, DistribArrayShape)
            and self._lens == other._lens
            and self._caps == other._caps
        )


def create_shape(caps: Sequence[int]) -> DistribArrayShape:
    """Empty shape with the given capacities (reference: CreateShape,
    interface.go:48-56)."""
    return DistribArrayShape([0] * len(caps), caps)


def create_shape_uniform(cap: int, npart: int) -> DistribArrayShape:
    """Empty shape with npart equal-capacity partitions (reference:
    CreateShapeUniform, interface.go:58-62)."""
    return DistribArrayShape([0] * npart, [cap] * npart)


class PartReader(abc.ABC):
    """Sequential byte reader over one partition (or a range of it).

    ``read(n)`` returns at most n bytes, b"" at EOF; ``read()``/``read(-1)``
    returns the remainder.  Mirrors Python file-object semantics rather than
    Go's (n, io.EOF) pairs — the pedantic Go EOF contracts
    (data_test.go:39-65) map onto "empty bytes at EOF" here.
    """

    @abc.abstractmethod
    def read(self, n: int = -1) -> bytes: ...

    def close(self) -> None:  # noqa: B027 - optional hook
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class PartWriter(abc.ABC):
    """Appending byte writer over one partition.

    ``write`` appends at the partition's current length and raises
    :class:`CapacityError` if the write would exceed the fixed capacity
    (reference: mem.go:38-53).  Data is guaranteed visible to new readers
    only after the *array's* ``close()`` commits (file backend flushes
    meta.json then, file.go:238-249); backends may make it visible earlier.
    """

    @abc.abstractmethod
    def write(self, data: bytes) -> int: ...

    def close(self) -> None:  # noqa: B027 - optional hook
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class DistribArray(abc.ABC):
    """Named array of append-only fixed-capacity byte partitions
    (reference: DistribArray, interface.go:74-99)."""

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def get_shape(self) -> DistribArrayShape: ...

    @abc.abstractmethod
    def get_part_reader(self, part_idx: int) -> PartReader: ...

    @abc.abstractmethod
    def get_part_range_reader(
        self, part_idx: int, start: int, end: int
    ) -> PartReader:
        """Reader over bytes [start, end) of a partition; ``end <= 0`` means
        ``committed_len + end`` (canonicalized on len — see module docs)."""

    @abc.abstractmethod
    def get_part_writer(self, part_idx: int) -> PartWriter: ...

    @abc.abstractmethod
    def close(self) -> None:
        """Commit written data/metadata (reference: file.go:238-249)."""

    @abc.abstractmethod
    def destroy(self) -> None:
        """Release all storage; the array name becomes reusable
        (reference: file.go Destroy = os.RemoveAll)."""

    # Convenience (mirrors pylibsort ReadAll/WriteAll, data.py:203-226).
    def read_part(self, part_idx: int) -> bytes:
        with self.get_part_reader(part_idx) as r:
            return r.read()

    def write_part(self, part_idx: int, data: bytes) -> None:
        with self.get_part_writer(part_idx) as w:
            w.write(data)

    def read_all(self) -> bytes:
        shape = self.get_shape()
        return b"".join(self.read_part(i) for i in range(shape.npart))

    def write_all(self, parts: Sequence[bytes]) -> None:
        for i, p in enumerate(parts):
            self.write_part(i, p)


class PartRef(NamedTuple):
    """Reference to bytes [start, start+nbyte) of one partition
    (reference: PartRef, interface.go:101-107).

    A NamedTuple, not a frozen dataclass: width-16 rounds materialize up to
    2^16 * nworker refs per round, and frozen-dataclass construction
    (object.__setattr__ per field) cost ~2us per ref — the bulk of the w16
    metadata budget (VERDICT r2 item 7)."""

    arr: DistribArray
    part_idx: int
    start: int
    nbyte: int

    def reader(self) -> PartReader:
        if self.nbyte == 0:
            # end == start would hit the backends' "end <= 0 means len+end"
            # convention when start == 0 and read the WHOLE partition; an
            # empty ref must yield an empty reader.
            import io

            return io.BytesIO(b"")
        return self.arr.get_part_range_reader(
            self.part_idx, self.start, self.start + self.nbyte
        )


class ArrayFactory(abc.ABC):
    """Create/open arrays by name (reference: ArrayFactory,
    interface.go:109-112).  A factory encapsulates the backend and its root
    (registry, directory, device) so orchestration code is backend-blind."""

    @abc.abstractmethod
    def create(self, name: str, shape: DistribArrayShape) -> DistribArray: ...

    @abc.abstractmethod
    def open(self, name: str) -> DistribArray: ...

    def destroy_named(self, name: str) -> None:
        """Destroy an array by name if it exists (idempotent) — used by
        checkpoint/resume to clear partial outputs of a crashed round.
        Backends override when storage can be left half-created."""
        try:
            self.open(name).destroy()
        except FileNotFoundError:
            pass


def iter_refs_bytes(refs: Sequence[PartRef]) -> Iterator[bytes]:
    for ref in refs:
        with ref.reader() as r:
            chunk = r.read()
        if len(chunk) != ref.nbyte:
            raise IOError(
                f"short read from {ref.arr.name}[{ref.part_idx}]: "
                f"want {ref.nbyte} bytes, got {len(chunk)}"
            )
        yield chunk
