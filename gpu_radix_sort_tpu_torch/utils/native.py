"""ctypes loader for the port's native host library (``native/sortcore.cpp``).

Port of ``gpu_radix_sort_tpu/utils/native.py``: the host-side work that is
hot enough to matter off the interpreter -- the PCG32 fill of
:class:`utils.keygen.Pcg32`, the CPU oracle sorts and the digit histogram.

The library is built from the port's own source with ``g++ -O3 -shared
-fPIC`` at first use into ``gpu_radix_sort_tpu_torch/_build/``, under a name
that hashes the source and the flags: an edited source builds anew, an
unchanged one loads the library already built.  It never loads the JAX
package's ``libsortcore.so``.

Where the JAX loader marks the library unavailable and its callers fall back
to numpy, this one raises: a failed build raises with the compiler's
stderr, and nothing falls back.

:func:`build` and :func:`load` are safe under concurrent first use: one lock
makes the first thread of a process build and the others wait for its
library, and the compiler writes a temporary file named by the process and
the thread, renamed into place atomically, so processes that build at once
(the test workers) never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "sortcore.cpp"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-Wall", "-Wextra")

_U32P = ctypes.POINTER(ctypes.c_uint32)
_SIGNATURES = {
    # (state, out, n) -> state after n steps
    "pcg32_fill": (ctypes.c_uint64, (ctypes.c_uint64, _U32P, ctypes.c_uint64)),
    # (data, n) -> true
    "cpu_sort_u32": (ctypes.c_bool, (_U32P, ctypes.c_uint64)),
    # (data, boundaries, n, offset, width) -> false on a bad range
    "cpu_partial_u32": (ctypes.c_bool, (_U32P, _U32P, ctypes.c_uint64, ctypes.c_uint32,
                                        ctypes.c_uint32)),
    # (data, n, offset, width, counts)
    "histogram_u32": (None, (_U32P, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
                             ctypes.POINTER(ctypes.c_uint64))),
}

_LOCK = threading.RLock()  # one build at a time in a process
_LIB: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsortcore_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/sortcore.cpp`` unless the library for this source
    exists; raise if the compiler cannot run or fails."""
    with _LOCK:
        lib = library_path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.so.tmp"
        cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"cannot run the C++ compiler: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{CXX} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, lib)
        return lib


def load() -> ctypes.CDLL:
    """The native library, built on the first call in a process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = lib
        return _LIB


def _u32_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U32P)


def _check_range(offset: int, width: int) -> None:
    # the C side shifts by offset and width: out of range is undefined
    if width <= 0 or width > 32 or offset < 0 or offset + width > 32:
        raise ValueError(f"invalid digit range offset={offset} width={width}")


def pcg32_fill(state: np.uint64, n: int) -> tuple[np.ndarray, np.uint64]:
    """(the next ``n`` words of the PCG32 stream at ``state``, the state
    after them)."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    out = np.empty(n, dtype=np.uint32)
    new_state = load().pcg32_fill(int(state), _u32_ptr(out), n)
    return out, np.uint64(new_state)


def cpu_sort(keys: np.ndarray) -> np.ndarray:
    """Ascending sort of uint32 keys (a copy), by ``std::sort``."""
    out = np.ascontiguousarray(keys, dtype=np.uint32).copy()
    load().cpu_sort_u32(_u32_ptr(out), out.size)
    return out


def cpu_partial(keys: np.ndarray, offset: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """(stable sort of a copy by bits [offset, offset+width), the
    reference's boundaries uint32[2^width])."""
    _check_range(offset, width)
    out = np.ascontiguousarray(keys, dtype=np.uint32).copy()
    boundaries = np.zeros(1 << width, dtype=np.uint32)
    if not load().cpu_partial_u32(_u32_ptr(out), _u32_ptr(boundaries), out.size, offset,
                                  width):
        raise ValueError(f"invalid partial-sort args offset={offset} width={width}")
    return out, boundaries


def histogram(keys: np.ndarray, offset: int, width: int) -> np.ndarray:
    """Counts uint64[2^width] of the digit at bits [offset, offset+width)."""
    _check_range(offset, width)
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    counts = np.zeros(1 << width, dtype=np.uint64)
    load().histogram_u32(_u32_ptr(keys), keys.size, offset, width,
                         counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return counts
