"""The out-of-core runner of the PyTorch port
(``gpu_radix_sort_tpu_torch/benchmarks/run_out_of_core.py``) vs the JAX
package's (``benchmarks/run_out_of_core.py``, loaded by path), on the CPU.

Everything runs in this process at tiny sizes under ``tmp_path`` (no file
above ~2 MiB, no child process); ~10 s on one worker.  The two runners go
side by side on three cases only (the JAX side compiles a sort for each
padded shard shape and digit offset): exit codes, JSON fields and the
sorted streams byte for byte.  The rest holds the port to its own oracle
and to the JAX runner's words: the payload bytes, the argument errors, the
staged file, a wrong-size staged input, and the streaming proof on
tampered outputs (the JAX runner's proof reached by replacing its sort,
so no JAX program runs there).

B5's tile and the runner's chunk are cut so that each binning pass runs
many tiles and the staging and the proof cross chunk edges."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu import data as jdata
from gpu_radix_sort_tpu_torch import data as pdata
from gpu_radix_sort_tpu_torch.benchmarks import run_out_of_core as pr
from gpu_radix_sort_tpu_torch.ops import binning as bn
from gpu_radix_sort_tpu_torch.utils.keygen import Pcg32

REPO = Path(__file__).resolve().parents[1]
SMALL_TILE = 256
SMALL_CHUNK = 1000  # rows a staging and proof chunk
N_TAMPER = 1 << 16  # the first rows of the PCG32 stream that hold an equal-key pair
PB_TAMPER = 16  # a u64 index and 4 filler bytes


@pytest.fixture(scope="module")
def jr():
    """The JAX runner, loaded by path (its sys.path insert undone)."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "_jax_run_out_of_core", REPO / "benchmarks" / "run_out_of_core.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


@pytest.fixture(autouse=True)
def small_geometry(monkeypatch):
    monkeypatch.setattr(bn, "TILE", SMALL_TILE)
    monkeypatch.setattr(pr, "CHUNK_ROWS", SMALL_CHUNK)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _capture_streams(monkeypatch, mod) -> list:
    """Record the STRIDED byte stream of every sort's outputs in ``mod``
    (before the runner proves and destroys them)."""
    streams = []
    real = mod.sort_distrib_from_arr

    def sort(*args, **kwargs):
        outputs = real(*args, **kwargs)
        streams.append(mod.BucketReader(outputs, mod.ReadOrder.STRIDED).read())
        return outputs

    monkeypatch.setattr(mod, "sort_distrib_from_arr", sort)
    return streams


def _run_jax(jr, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["run_out_of_core.py", *argv])
    with pytest.raises(SystemExit) as exc:
        jr.main()
    out, err = capsys.readouterr()
    return exc.value.code, out, err


def _run_port(argv, capsys):
    rc = pr.main(["--device", "cpu", *argv])
    out, err = capsys.readouterr()
    return rc, out, err


def _line(out: str) -> dict:
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    return json.loads(lines[0])


def _want_stream(n: int, pb: int) -> bytes:
    """The sorted rows of the runner's input, by numpy's stable order."""
    keys = Pcg32().fill(n)
    order = np.argsort(keys, kind="stable")
    if not pb:
        return keys[order].tobytes()
    rows = np.empty((n, 4 + pb), dtype=np.uint8)
    rows[:, :4] = keys.view(np.uint8).reshape(n, 4)
    pr.payload_for(keys, 0, pb, out=rows[:, 4:])
    return rows[order].tobytes()


@pytest.mark.parametrize("idx0", [0, (1 << 32) - 3])
@pytest.mark.parametrize("pb", [8, 9, 12, 64])
def test_payload_for_matches_jax(jr, pb, idx0):
    keys = np.random.default_rng(pb).integers(0, 1 << 32, 37, dtype=np.uint32)
    want = jr.payload_for(keys, idx0, pb)
    got = pr.payload_for(keys, idx0, pb)
    assert got.dtype == np.uint8 and got.shape == (37, pb)
    assert got.tobytes() == want.tobytes()
    out = np.zeros((37, pb), dtype=np.uint8)
    assert pr.payload_for(keys, idx0, pb, out=out) is out
    assert out.tobytes() == want.tobytes()


def test_payload_for_refuses_a_short_payload():
    with pytest.raises(ValueError, match="binding \\+ index"):
        pr.payload_for(np.zeros(3, np.uint32), 0, 7)


@pytest.mark.parametrize("argv", [
    ["--payload-bytes", "4"],
    ["--payload-bytes", "8", "--rows", str((1 << 32) + 1)],
    ["--rows", "many"],
], ids=["short-payload", "u32-index", "not-an-int"])
def test_argument_errors_match_jax(jr, argv, tmp_path, monkeypatch, capsys):
    mount = ["--mount", str(tmp_path / "m")]
    rc_j, out_j, err_j = _run_jax(jr, argv + mount, monkeypatch, capsys)
    rc_p, out_p, err_p = _run_port(argv + mount, capsys)
    assert rc_j == rc_p == 2
    assert out_j == out_p == ""
    assert err_p.splitlines()[-1].split(" error: ")[1] == \
        err_j.splitlines()[-1].split(" error: ")[1]
    assert not (tmp_path / "m").exists()


def test_defaults_are_the_jax_runners():
    args = pr.parse_args([])
    assert (args.rows, args.payload_bytes, args.width, args.nworker, args.name) == (
        1 << 30, 0, 8, 1, "ooc")
    assert not (args.parallel_workers or args.stage_only or args.skip_staging)
    assert args.device == "cuda"


def test_without_cuda_the_runner_raises_before_staging(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        pr.main(["--rows", "16", "--mount", str(tmp_path / "m")])
    assert not (tmp_path / "m").exists()


@pytest.mark.parametrize("rows,pb,nworker", [
    ((1 << 14) + 3, 0, 1),
    ((1 << 14) + 3, 0, 3),
    ((1 << 12) + 5, 64, 2),
], ids=["keys-w1", "keys-w3", "kv64-w2"])
def test_runner_matches_jax(jr, rows, pb, nworker, tmp_path, monkeypatch, capsys):
    argv = ["--rows", str(rows), "--payload-bytes", str(pb), "--nworker", str(nworker)]
    j_streams = _capture_streams(monkeypatch, jr)
    p_streams = _capture_streams(monkeypatch, pr)
    rc_j, out_j, err_j = _run_jax(
        jr, argv + ["--mount", str(tmp_path / "jax")], monkeypatch, capsys)
    rc_p, out_p, err_p = _run_port(argv + ["--mount", str(tmp_path / "port")], capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    j, p = _line(out_j), _line(out_p)
    keys = ("metric", "rows", "row_bytes", "exact")
    assert [p[k] for k in keys] == [j[k] for k in keys]
    assert p["exact"] is True
    assert set(p) == set(j)
    assert p["phases"]["counter:rounds"] == j["phases"]["counter:rounds"] == 4
    assert len(j_streams) == len(p_streams) == 1
    assert p_streams[0] == j_streams[0] == _want_stream(rows, pb)
    assert "EXACT" in err_p


@pytest.mark.parametrize("rows,pb,width,nworker", [
    ((1 << 12) + 1, 0, 4, 2),
    ((1 << 12) + 1, 0, 16, 2),
    ((1 << 12) + 3, 8, 8, 3),
    ((1 << 12) + 3, 12, 8, 2),
], ids=["keys-w4", "keys-w16", "kv8", "kv12"])
def test_runner_is_exact(rows, pb, width, nworker, tmp_path, monkeypatch, capsys):
    streams = _capture_streams(monkeypatch, pr)
    rc, out, _ = _run_port(["--rows", str(rows), "--payload-bytes", str(pb),
                            "--width", str(width), "--nworker", str(nworker),
                            "--mount", str(tmp_path)], capsys)
    assert rc == 0
    line = _line(out)
    kind = f"kv{pb}B" if pb else "keys"
    assert line["metric"] == f"out_of_core_{kind}_w{width}"
    assert (line["rows"], line["row_bytes"], line["exact"]) == (rows, 4 + pb, True)
    assert line["phases"]["counter:rounds"] == 32 // width
    assert streams == [_want_stream(rows, pb)]
    assert list(tmp_path.iterdir()) == []  # the input consumed, the outputs destroyed


def test_stage_only_then_skip_staging(jr, tmp_path, monkeypatch, capsys):
    rows, pb = (1 << 12) + 7, 12
    argv = ["--rows", str(rows), "--payload-bytes", str(pb), "--nworker", "2"]
    streams = _capture_streams(monkeypatch, pr)
    rc, out, err = _run_port(argv + ["--mount", str(tmp_path / "p"), "--stage-only"],
                             capsys)
    assert (rc, out) == (0, "") and "stage-only: done" in err
    # the staged file is the JAX runner's, byte for byte (staging runs no JAX program)
    rc_j, _, _ = _run_jax(jr, argv + ["--mount", str(tmp_path / "j"), "--stage-only"],
                          monkeypatch, capsys)
    assert rc_j == 0
    staged = [(tmp_path / side / "ooc.input" / "data.dat").read_bytes() for side in "pj"]
    assert len(staged[0]) == rows * (4 + pb) and staged[0] == staged[1]
    rc, out, err = _run_port(argv + ["--mount", str(tmp_path / "p"), "--skip-staging"],
                             capsys)
    assert rc == 0 and _line(out)["exact"] is True and "reused staged input" in err
    rc, out, _ = _run_port(argv + ["--mount", str(tmp_path / "q")], capsys)
    assert rc == 0
    assert len(streams) == 2 and streams[0] == streams[1] == _want_stream(rows, pb)


def test_wrong_size_staged_input_exits_2(jr, tmp_path, monkeypatch, capsys):
    rows = 1000
    for side, run in (("p", lambda a: _run_port(a, capsys)),
                      ("j", lambda a: _run_jax(jr, a, monkeypatch, capsys))):
        mount = ["--mount", str(tmp_path / side)]
        assert run(["--rows", str(rows), "--stage-only"] + mount)[0] == 0
        rc, out, err = run(["--rows", str(rows + 1), "--skip-staging"] + mount)
        assert (rc, out) == (2, "")
        assert err.splitlines()[-1] == (
            f"FATAL: staged input holds {rows * 4} bytes, want {(rows + 1) * 4}")


def _tampered_rows(case: str) -> tuple[np.ndarray, str, int]:
    """The sorted rows of the N_TAMPER-row input with one fault, the proof's
    message for it, and the chunk that shows it there."""
    n, chunk = N_TAMPER, SMALL_CHUNK
    rows = np.frombuffer(_want_stream(n, PB_TAMPER), np.uint8).reshape(n, -1).copy()
    keys = rows[:, :4].copy().view(np.uint32).reshape(-1)
    pair = int(np.flatnonzero(keys[1:] == keys[:-1])[0])  # rows pair, pair + 1
    at = lambda r: r // chunk * chunk  # noqa: E731 - the first row of r's chunk
    r = 12345
    if case == "key-swap":
        rows[[r, r + 700]] = rows[[r + 700, r]]
        return rows, f"key mismatch in chunk at row {at(r)}", chunk
    if case == "binding":
        rows[r, 5] ^= 1
        return rows, f"payload/key binding broken at row {at(r)}", chunk
    if case == "index-range":
        rows[r, 8:16] = np.frombuffer(np.uint64(n).tobytes(), np.uint8)
        return rows, "out-of-range original index", chunk
    if case == "filler":
        rows[r, -1] ^= 0x40
        return rows, f"payload filler mismatch at row {at(r)}", chunk
    if case == "stability":
        rows[[pair, pair + 1]] = rows[[pair + 1, pair]]
        return rows, f"stability violated near row {at(pair)}", chunk
    if case == "stability-chunk-edge":  # the pair's second row starts a chunk
        rows[[pair, pair + 1]] = rows[[pair + 1, pair]]
        return rows, f"stability violated near row {pair + 1}", pair + 1
    if case == "dropped-row":
        return rows[:-1], f"linearized {n - 1} rows, expected {n}", chunk
    raise ValueError(case)


def _one_array(data_mod, rows: np.ndarray):
    arr = data_mod.MemArrayFactory().create("t", data_mod.create_shape([rows.nbytes]))
    arr.write_part(0, rows.tobytes())
    arr.close()
    return arr


@pytest.mark.parametrize("case", [
    "key-swap", "binding", "index-range", "filler", "stability",
    "stability-chunk-edge", "dropped-row"])
def test_proof_catches_a_tampered_output(jr, case, tmp_path, monkeypatch, capsys):
    rows, message, chunk = _tampered_rows(case)
    monkeypatch.setattr(pr, "CHUNK_ROWS", chunk)
    assert pr.verify_stream([_one_array(pdata, rows)], N_TAMPER, PB_TAMPER) == (
        False, message)
    # the JAX runner's proof on the same rows, its sort replaced by them
    monkeypatch.setattr(jr, "CHUNK_ROWS", chunk)
    monkeypatch.setattr(jr, "sort_distrib_from_arr",
                        lambda *a, **k: [_one_array(jdata, rows)])
    rc, out, err = _run_jax(jr, ["--rows", str(N_TAMPER), "--payload-bytes",
                                 str(PB_TAMPER), "--mount", str(tmp_path)],
                            monkeypatch, capsys)
    assert rc == 1 and _line(out)["exact"] is False
    assert f"FATAL: {message}" in err.splitlines()


def test_proof_passes_the_untampered_output():
    rows = np.frombuffer(_want_stream(N_TAMPER, PB_TAMPER), np.uint8).reshape(N_TAMPER, -1)
    assert pr.verify_stream([_one_array(pdata, rows)], N_TAMPER, PB_TAMPER) == (True, "")
