"""Build the package's CUDA kernels at first use and load them with ctypes.

The counterpart of ``gpu_radix_sort_tpu/utils/native.py``'s build at first
use.  Each of ``csrc/*.cu`` goes through its own ``nvcc -c``, all started
together, and one more ``nvcc`` links the objects into a shared library with
a plain C interface (no PyTorch headers, so the build takes seconds),
placed in ``gpu_radix_sort_tpu_torch/_build/`` under a name that hashes the
sources, the headers they share (``csrc/*.cuh``) and the flags: an edited
source or header builds anew, an unchanged tree loads the library already
built.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.  A failed
``nvcc`` raises with its stderr.  Nothing falls back.

:func:`build` and :func:`load` are safe to call from several threads at
once (the storage round loop runs its workers as threads): one lock makes
the first caller build and the others wait for its library, and the
temporary objects carry the process and the thread in their names, so two
processes that build at once write different files.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_SIGNATURES = {
    # (x, out, n, tile, alternate, stream)
    "grs_block_sort_u32": (_P, _P, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, _P),
    # (x, out, n, stream)
    "grs_single_block_sort_u32": (_P, _P, ctypes.c_longlong, _P),
    # (x, out, n, L, stream)
    "grs_merge_level_u32": (_P, _P, ctypes.c_longlong, ctypes.c_longlong, _P),
    # (x, out, n, offset, width, stream)
    "grs_digit_sort_u32": (_P, _P, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, _P),
    # (keys, src, out, n, tile, offset, width, g_run, sflat, stream)
    "grs_binning_u32": (_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_int, _P, _P, _P),
    # (src, n_src, segs, n_seg, dst_ptrs, nranks, stream)
    "grs_segment_copy_u32": (_P, ctypes.c_longlong, _P, ctypes.c_int, _P,
                             ctypes.c_int, _P),
    # (x, n, tile, offset, width, sched, nranks, dst_ptrs, stage, stream)
    "grs_group_sort_send_u32": (_P, ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
                                _P, _P, _P),
    # (x, tmp, out, n, scratch, scratch_words, stream)
    "grs_onesweep_sort_u32": (_P, _P, _P, ctypes.c_longlong, _P, ctypes.c_longlong, _P),
    # (tile, header)
    "grs_onesweep_geometry": (_P, _P),
    # (device, peer)
    "grs_enable_peer_access": (ctypes.c_int, ctypes.c_int),
    # () -> the size of an IPC handle
    "grs_ipc_handle_bytes": (),
    # (device, bytes, ptr_out)
    "grs_ipc_alloc": (ctypes.c_int, ctypes.c_longlong, _P),
    # (device, ptr, handle_out)
    "grs_ipc_export": (ctypes.c_int, _P, _P),
    # (device, handle, ptr_out)
    "grs_ipc_open": (ctypes.c_int, _P, _P),
    # (device, ptr)
    "grs_ipc_close": (ctypes.c_int, _P),
    "grs_ipc_free": (ctypes.c_int, _P),
    # (tile, blocks, smem_bytes)
    "grs_block_sort_blocks_per_sm": (ctypes.c_int, _P, _P),
    # (blocks, smem_bytes)
    "grs_merge_level_blocks_per_sm": (_P, _P),
    # (n, width, blocks, smem_bytes)
    "grs_digit_sort_blocks_per_sm": (ctypes.c_longlong, ctypes.c_int, _P, _P),
    # (blocks, smem_bytes)
    "grs_onesweep_blocks_per_sm": (_P, _P),
    # (tile, width, nranks, blocks, smem_bytes)
    "grs_group_sort_send_blocks_per_sm": (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                          _P, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libgrs_kernels_{digest.hexdigest()[:16]}.so"


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> None:
    """Wait for every process; raise with the stderr of the first failure."""
    failed = None
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, err)
    if failed is not None:
        cmd, rc, err = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")


def _start(cmd: list[str]) -> tuple[list[str], subprocess.Popen]:
    return cmd, subprocess.Popen(
        cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True
    )


_LOCK = threading.RLock()  # one build at a time in a process
_LIB: ctypes.CDLL | None = None


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one ``nvcc -c`` a source, in parallel, then one link."""
    with _LOCK:
        lib = library_path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{lib.stem}.{os.getpid()}.{threading.get_ident()}"
        objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
        try:
            _run([
                _start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
                for src, obj in zip(_sources(), objects)
            ])
            tmp = BUILD_DIR / f"{tag}.so.tmp"
            _run([_start([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                          *map(str, objects)])])
            os.replace(tmp, lib)
        finally:
            for obj in objects:
                obj.unlink(missing_ok=True)
        return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on the first call in a process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.grs_error_string.argtypes = (ctypes.c_int,)
            lib.grs_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        text = load().grs_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({text})")
