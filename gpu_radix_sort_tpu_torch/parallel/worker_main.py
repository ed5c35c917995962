"""Worker process entry: sort-round events over stdin.

Port of ``gpu_radix_sort_tpu/parallel/worker_main.py`` (the reference's
faasTest/f.py ``directInvoke`` mode, f.py:147-182): read an event JSON from
stdin, mount the shared file-array root from the environment
(``GRS_TPU_MOUNT``), run the handler on the device named by ``GRS_DEVICE``
(the CUDA device when unset), answer ``{"success": bool, "err": str}`` on
stdout.  With no CUDA device and no ``GRS_DEVICE=cpu`` every event answers
``{"success": false, ...}``.  ``GRS_PROFILE_DIR`` turns on a cProfile dump
an event (reference: f.py:24-36).

Two modes:
  * one-shot (default): the whole of stdin is one event; one response; exit
    (the reference's process an invocation);
  * ``--serve``: line-delimited JSON events until EOF, one response line an
    event, after a ``{"ready": true}`` line (used by
    :class:`parallel.serverless.WorkerPool`, whose workers keep their
    process and CUDA context across rounds).

Run as ``python -m gpu_radix_sort_tpu_torch.parallel.worker_main [--serve]``.
"""

from __future__ import annotations

import json
import os
import sys


def _handle(event: dict, mount: str, device: str | None, profile_dir: str | None) -> dict:
    profiler = None
    if profile_dir:
        import cProfile

        profiler = cProfile.Profile()
        profiler.enable()

    try:
        from ..data.file import FileArrayFactory
        from .serverless import handle_event

        handle_event(event, FileArrayFactory(mount), device=device)
        response = {"success": True, "err": ""}
    except Exception as e:  # noqa: BLE001 - the worker boundary reports every error
        response = {"success": False, "err": f"{type(e).__name__}: {e}"}

    if profiler is not None:
        profiler.disable()
        os.makedirs(profile_dir, exist_ok=True)
        tag = f"worker_{event.get('output', 'unknown')}_{os.getpid()}"
        profiler.dump_stats(os.path.join(profile_dir, f"{tag}.prof"))
        import io
        import pstats

        buf = io.StringIO()
        pstats.Stats(profiler, stream=buf).sort_stats("cumulative").print_stats(30)
        with open(os.path.join(profile_dir, f"{tag}.txt"), "w") as f:
            f.write(buf.getvalue())
    return response


def main() -> int:
    from .serverless import DEVICE_ENV, MOUNT_ENV, PROFILE_ENV

    serve = "--serve" in sys.argv[1:]
    mount = os.environ.get(MOUNT_ENV)
    # Errors are in-band ({success: false} on stdout, exit 0) on every
    # validation path: invoke_subprocess surfaces stderr only on a nonzero
    # exit, so exiting 1 after printing JSON would lose the message.
    if not mount:
        print(json.dumps({"success": False, "err": f"{MOUNT_ENV} not set"}), flush=True)
        return 0
    device = os.environ.get(DEVICE_ENV) or None
    profile_dir = os.environ.get(PROFILE_ENV)

    if not serve:
        try:
            event = json.load(sys.stdin)
        except json.JSONDecodeError as e:
            print(json.dumps({"success": False, "err": f"bad event JSON: {e}"}))
            return 0
        print(json.dumps(_handle(event, mount, device, profile_dir)))
        return 0  # handler errors are in-band; nonzero = process failure

    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            event = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"success": False, "err": f"bad event JSON: {e}"}), flush=True)
            continue
        print(json.dumps(_handle(event, mount, device, profile_dir)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
