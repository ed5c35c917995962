"""The kernel build of the PyTorch port (kernels/build.py) under concurrent
first use: the storage round loop runs its workers as threads of one
process, and each may launch its first kernel at once.  The compiler is a
stub that writes the files nvcc would, so this runs with no CUDA
toolkit."""

import stat
import sys
import threading

from gpu_radix_sort_tpu_torch.kernels import build

STUB = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({log!r}, "a") as log:
    log.write(out + "\\n")
time.sleep(0.05)  # a window for another build to collide in
with open(out, "wb") as f:
    f.write(b"object or library")
"""


def test_build_from_four_threads_makes_one_library(tmp_path, monkeypatch):
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STUB.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    out_dir = tmp_path / "_build"
    monkeypatch.setattr(build, "BUILD_DIR", out_dir)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))

    barrier = threading.Barrier(4)
    results, errors = [], []

    def first_use():
        barrier.wait()
        try:
            results.append(build.build())
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)

    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(set(results)) == 1
    lib = results[0]
    assert lib.parent == out_dir and lib.read_bytes() == b"object or library"
    outputs = log.read_text().split()
    assert len(outputs) == len(set(outputs)), "two builds wrote the same file"
    n_sources = len(build._sources())
    assert len(outputs) == n_sources + 1  # one build: an object a source, one link
    assert sorted(p.name for p in out_dir.iterdir()) == [lib.name]  # no temporaries left
