"""On-disk file backend for DistribArray.

Port of ``gpu_radix_sort_tpu/data/file.py`` (host code, kept as it is): an
array written by either package reads back byte-equal in the other.

Reference analog: benchmark/pkg/data/file.go and its Python mirror
faasTest/pylibsort/data.py — one directory per array containing

  * ``data.dat``  — all partitions concatenated at fixed offsets
                    ``starts[i] = sum(caps[:i])`` (file.go:146-160);
  * ``meta.json`` — ``{"Lens": [...], "Caps": [...]}`` (file.go:36-52,
                    data.py:122-131).

The format is kept byte-compatible with the reference wire protocol (it is
what the reference's Go host and Python FaaS workers exchange); here it
serves the same role for subprocess workers (parallel/serverless.py) and as
the spill / checkpoint plane (parallel/storage_sort.py checkpointing).

Readers open their own file handle (thread safety, file.go:214-216); writers
append at ``starts[i] + lens[i]``; ``close()`` commits meta.json
(file.go:238-249); ``destroy()`` removes the directory.
"""

from __future__ import annotations

import json
import os
import shutil
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

DATA_FILE = "data.dat"
META_FILE = "meta.json"


def _close_box(box: list) -> None:
    """weakref.finalize target: close a boxed file handle, ignoring errors
    (interpreter shutdown may have torn down IO already)."""
    handle, box[0] = box[0], None
    if handle is not None:
        try:
            handle.close()
        except Exception:
            pass


def _meta_dump(shape: DistribArrayShape) -> str:
    # Exact reference key names (file.go:46-52 / data.py:127-131).
    return json.dumps({"Lens": list(shape.lens), "Caps": list(shape.caps)})


def _meta_load(path: str) -> DistribArrayShape:
    with open(path, "r") as f:
        meta = json.load(f)
    return DistribArrayShape(meta["Lens"], meta["Caps"])


class _FilePartReader(PartReader):
    def __init__(self, path: str, start: int, nbyte: int):
        self._f = open(path, "rb")
        self._f.seek(start)
        self._remaining = nbyte

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0 or n > self._remaining:
            n = self._remaining
        out = self._f.read(n)
        self._remaining -= len(out)
        return out

    def close(self) -> None:
        self._f.close()


class _FilePartWriter(PartWriter):
    def __init__(self, arr: "FileDistribArray", part_idx: int):
        self._arr = arr
        self._idx = part_idx

    def write(self, data: bytes) -> int:
        return self._arr._append(self._idx, data)


class FileDistribArray(DistribArray):
    def __init__(self, root: str, name: str, shape: DistribArrayShape):
        self._root = root
        self._name = name
        self._shape_lens = list(shape.lens)
        self._caps = shape.caps
        self._starts = shape.starts()
        self._lock = threading.Lock()
        self._dirty = False
        # Persistent append handle (lazy; see _append), held in a one-slot
        # box so a weakref finalizer can close it if the array is dropped
        # without close()/destroy() (e.g. a worker raising mid-round) —
        # otherwise the fd lives until GC.
        self._wf_box: list = [None]
        self._finalizer = weakref.finalize(self, _close_box, self._wf_box)

    @property
    def _wf(self):
        return self._wf_box[0]

    @_wf.setter
    def _wf(self, handle) -> None:
        self._wf_box[0] = handle

    # -- construction -------------------------------------------------------

    @classmethod
    def create(cls, root: str, name: str, shape: DistribArrayShape):
        path = os.path.join(root, name)
        os.makedirs(path, exist_ok=False)
        arr = cls(root, name, shape)
        # Preallocate the data file to total capacity so partition offsets
        # are valid from the start (file.go:161-168 writes at starts[i]).
        with open(arr._data_path(), "wb") as f:
            total = sum(shape.caps)
            if total:
                f.truncate(total)
        arr._commit_meta()
        return arr

    @classmethod
    def open_existing(cls, root: str, name: str):
        path = os.path.join(root, name)
        shape = _meta_load(os.path.join(path, META_FILE))
        return cls(root, name, shape)

    # -- paths ---------------------------------------------------------------

    def _dir(self) -> str:
        return os.path.join(self._root, self._name)

    def _data_path(self) -> str:
        return os.path.join(self._dir(), DATA_FILE)

    def _meta_path(self) -> str:
        return os.path.join(self._dir(), META_FILE)

    def _commit_meta(self) -> None:
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            f.write(_meta_dump(self.get_shape()))
        os.replace(tmp, self._meta_path())  # atomic commit

    # -- DistribArray --------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name

    def get_shape(self) -> DistribArrayShape:
        with self._lock:
            return DistribArrayShape(list(self._shape_lens), self._caps)

    def _append(self, idx: int, data: bytes) -> int:
        with self._lock:
            ln = self._shape_lens[idx]
            if ln + len(data) > self._caps[idx]:
                raise CapacityError(
                    f"{self._name}[{idx}]: write of {len(data)} bytes exceeds "
                    f"cap {self._caps[idx]} (len {ln})"
                )
            # One persistent handle per array: a width-16 worker round
            # makes up to 2^16 write_part calls; reopening per append paid
            # open+close syscalls under the lock for every bucket.
            if self._wf is None:
                self._wf = open(self._data_path(), "r+b")
            self._wf.seek(self._starts[idx] + ln)
            self._wf.write(data)
            # No flush here: readers re-open the path, so buffered bytes
            # are flushed lazily when a reader is constructed (and at
            # close()).  A width-16 round makes up to 2^16 appends; one
            # flush syscall per append halved the persistent-handle win.
            self._shape_lens[idx] = ln + len(data)
            self._dirty = True
            return len(data)

    def _flush_writes_locked(self) -> None:
        if self._wf is not None:
            self._wf.flush()

    def get_part_reader(self, part_idx: int) -> PartReader:
        with self._lock:
            self._flush_writes_locked()
            ln = self._shape_lens[part_idx]
            start = self._starts[part_idx]
        return _FilePartReader(self._data_path(), start, ln)

    def get_part_range_reader(self, part_idx, start, end) -> PartReader:
        with self._lock:
            self._flush_writes_locked()
            ln = self._shape_lens[part_idx]
            base = self._starts[part_idx]
        if end <= 0:
            end = ln + end
        if start < 0 or end < start or end > ln:
            raise ValueError(
                f"{self._name}[{part_idx}]: range [{start}, {end}) out of "
                f"committed len {ln}"
            )
        return _FilePartReader(self._data_path(), base + start, end - start)

    def get_part_writer(self, part_idx: int) -> PartWriter:
        return _FilePartWriter(self, part_idx)

    def close(self) -> None:
        with self._lock:
            dirty = self._dirty
            self._dirty = False
            if self._wf is not None:
                self._wf.close()
                self._wf = None
        if dirty:
            self._commit_meta()

    def destroy(self) -> None:
        with self._lock:
            if self._wf is not None:
                self._wf.close()
                self._wf = None
        shutil.rmtree(self._dir(), ignore_errors=True)


class FileArrayFactory(ArrayFactory):
    """Factory rooted at a directory (reference: NewFileArrayFactory,
    file.go + the pylibsort mount point, data.py:16-31).  The root is the
    rendezvous shared with subprocess workers (the reference's
    OL_SHARED_VOLUME, benchmark.go:79)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def create(self, name: str, shape: DistribArrayShape) -> DistribArray:
        return FileDistribArray.create(self.root, name, shape)

    def open(self, name: str) -> DistribArray:
        return FileDistribArray.open_existing(self.root, name)

    def destroy_named(self, name: str) -> None:
        # Robust to half-created arrays (directory without meta.json), which
        # open() would reject — crash cleanup must still remove them.
        shutil.rmtree(os.path.join(self.root, name), ignore_errors=True)
