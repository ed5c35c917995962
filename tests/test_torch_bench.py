"""The port's benchmark harness (gpu_radix_sort_tpu_torch/bench) against the
JAX package's, on the CPU.

Every ``bench_*`` function of both harnesses runs at a small n with one rep
(the mesh rows on the port's ``[cpu] * 8`` beside JAX's 8 virtual CPU
devices); their records must agree in everything that does not depend on
the clock.  The suites' composition is held row for row by replacing the
``bench_*`` functions with recorders, also with the on-card sizes; the
report and analyze text must be JAX's byte for byte."""

import dataclasses
import json
import time

import jax
import pytest
import torch

from gpu_radix_sort_tpu.bench import harness as jh
from gpu_radix_sort_tpu.cli import main as jax_cli
from gpu_radix_sort_tpu_torch.bench import analyze as ta
from gpu_radix_sort_tpu_torch.bench import harness as th
from gpu_radix_sort_tpu_torch.cli import main as port_cli
from gpu_radix_sort_tpu_torch.parallel.mesh import key_mesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 1 << 14
N_LOCAL = N // 8  # a rank's keys: 8 ranks
N_STORAGE = 1 << 12
# record extras that do not depend on the clock
FIXED_EXTRA = ("offset", "width", "strategy", "payload_bytes", "nchips", "overflow",
               "nworker")


def _single(h) -> dict:
    return {} if h is jh else {"device": CPU}


def _mesh(h) -> dict:
    return {} if h is jh else {"mesh": key_mesh([CPU] * 8)}


def _cfg(h, **kw):
    return h.SortConfig(**kw) if h is jh else h.SortConfig(device="cpu", **kw)


# one case a row kind: every bench_* function, the storage ones on both
# backends that the suites use
CASES = {
    "full_sort": lambda h: h.bench_full_sort(N, reps=1, **_single(h)),
    "full_sort_u64": lambda h: h.bench_full_sort_u64(N, reps=1, **_single(h)),
    "partial_sort_w8": lambda h: h.bench_partial_sort(N, width=8, reps=1, **_single(h)),
    "partial_sort_w16_refcontract": lambda h: h.bench_partial_sort(
        N, width=16, reps=1, stable=False, **_single(h)),
    "key_value_sort_p8B": lambda h: h.bench_key_value_sort(N, reps=1, **_single(h)),
    "key_value_sort_p64B": lambda h: h.bench_key_value_sort(
        N // 16, payload_bytes=64, reps=1, **_single(h)),
    "kv_digit_sort": lambda h: h.bench_kv_digit_sort(N, reps=1, **_single(h)),
    "keygen": lambda h: h.bench_keygen(N, reps=1),
    "mesh_lsd": lambda h: h.bench_mesh_lsd(N_LOCAL, reps=1, **_mesh(h)),
    "mesh_sample": lambda h: h.bench_mesh_sample(N_LOCAL, reps=1, **_mesh(h)),
    "mesh_sort64": lambda h: h.bench_mesh_sort64(N_LOCAL // 2, reps=1, **_mesh(h)),
    "mesh_sort64_lsd": lambda h: h.bench_mesh_sort64_lsd(N_LOCAL // 2, reps=1, **_mesh(h)),
    "mesh_kv_sample": lambda h: h.bench_mesh_kv_sample(N_LOCAL // 4, reps=1, **_mesh(h)),
    "hash_aggregate": lambda h: h.bench_hash_aggregate(N_LOCAL, reps=1, **_mesh(h)),
    "storage_distrib_mem": lambda h: h.bench_storage_distrib(
        N_STORAGE, _cfg(h, backend="mem")),
    "storage_distrib_device": lambda h: h.bench_storage_distrib(
        N_STORAGE, _cfg(h, backend="device")),
    "storage_kv_mem": lambda h: h.bench_storage_kv(N_STORAGE, _cfg(h, backend="mem")),
    "storage_u64_mem": lambda h: h.bench_storage_u64(N_STORAGE, _cfg(h, backend="mem")),
    "storage_u64_device": lambda h: h.bench_storage_u64(
        N_STORAGE, _cfg(h, backend="device")),
}


def _fixed(rec) -> dict:
    """What of a record does not depend on the clock: its name, size, reps,
    unit, extra keys, fixed extras, phase names with their sample counts,
    and counters."""
    phases = rec.extra.get("phases", {})
    return {
        "name": rec.name, "n": rec.n, "reps": rec.reps, "unit": rec.unit,
        "extra_keys": sorted(rec.extra),
        "extra": {k: rec.extra[k] for k in FIXED_EXTRA if k in rec.extra},
        "phases": {k: v if k.startswith("counter:") else v["n"] for k, v in phases.items()},
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_bench_record_matches_jax(case):
    want, got = CASES[case](jh), CASES[case](th)
    assert _fixed(got) == _fixed(want)
    assert got.median_s > 0 and got.rate_per_s > 0
    assert got.mean_s > 0 and got.stdev_s == 0.0  # one rep


def test_bench_functions_are_the_jax_harness_functions():
    """Every bench_* function of the JAX harness has its port, and the
    package exports the same names."""
    import gpu_radix_sort_tpu.bench as jb
    import gpu_radix_sort_tpu_torch.bench as tb

    names = sorted(k for k in vars(jh) if k.startswith("bench_"))
    assert len(names) == 15
    assert names == sorted(k for k in vars(th) if k.startswith("bench_"))

    def exports(package):
        return sorted(k for k in vars(package)
                      if not k.startswith("_") and k not in ("harness", "analyze"))

    assert len(exports(jb)) == 13
    assert exports(tb) == exports(jb)


# ---------------------------------------------------------------------------
# The suites' composition
# ---------------------------------------------------------------------------

def _suite_calls(h, suite: str, monkeypatch) -> list:
    """(function, n, config, kwargs) of each row of ``run_benchmarks(suite)``,
    in order, with the port's ``device`` arguments left out."""
    calls = []

    def recorder(name):
        def bench(n, *args, **kwargs):
            cfg = {k: v for k, v in dataclasses.asdict(args[0]).items() if k != "device"} \
                if args else None
            kwargs = {k: v for k, v in kwargs.items() if k != "device"}
            calls.append((name, n, cfg, kwargs))
            return h.BenchRecord(name, n, 1, 1.0, 1.0, 0.0, float(n))
        return bench

    for name in [k for k in vars(h) if k.startswith("bench_")]:
        monkeypatch.setattr(h, name, recorder(name))
    h.run_benchmarks(suite, **({} if h is jh else {"device": "cpu"}))
    return calls


@pytest.mark.parametrize("on_card", [False, True])
@pytest.mark.parametrize("suite", ["quick", "full"])
def test_suite_composition_matches_jax(suite, on_card, monkeypatch):
    if on_card:  # the sizes JAX takes on a TPU, the port on a card
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
        monkeypatch.setattr(th, "_on_card", lambda device: True)
    want = _suite_calls(jh, suite, monkeypatch)
    got = _suite_calls(th, suite, monkeypatch)
    assert len(got) == 22
    assert got == want
    n1 = got[1][1]
    assert n1 == {("quick", False): 1 << 20, ("full", False): 1 << 22,
                  ("quick", True): 8 << 20, ("full", True): 256 << 20}[suite, on_card]
    mesh_lsd = next(c for c in got if c[0] == "bench_mesh_lsd")
    assert mesh_lsd[1] == (8 << 20 if (suite, on_card) == ("full", True) else n1 // 8)


def test_suite_runs_on_the_device_given(monkeypatch):
    """Every row but the host keygen gets the suite's device, the storage
    rows through their config; a CUDA suite without a card raises."""
    seen = []

    def recorder(name):
        def bench(n, *args, **kwargs):
            seen.append((name, kwargs.get("device", args[0].device if args else None)))
            return th.BenchRecord(name, n, 1, 1.0, 1.0, 0.0, float(n))
        return bench

    for name in [k for k in vars(th) if k.startswith("bench_")]:
        monkeypatch.setattr(th, name, recorder(name))
    th.run_benchmarks("quick", device="cpu")
    assert seen[0] == ("bench_keygen", None)
    assert {str(d) for _, d in seen[1:]} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        th.run_benchmarks("quick")


def test_run_scaling_on_a_cpu_mesh():
    recs = th.run_scaling(1 << 11, reps=1, devices=[CPU] * 8)
    assert [r.name for r in recs] == [f"scaling_sample_sort_{p}chip" for p in (1, 2, 4, 8)]
    assert [r.n for r in recs] == [p << 11 for p in (1, 2, 4, 8)]
    assert recs[0].extra["efficiency_vs_1chip"] == 1.0
    for r in recs:
        assert r.rate_per_s > 0 and "per_chip_rate" in r.extra and r.extra["overflow"] == 0


# ---------------------------------------------------------------------------
# Output formats
# ---------------------------------------------------------------------------

def _records(h) -> list:
    phases = {"workers": {"total_s": 0.08, "mean_s": 0.02, "stdev_s": 0.0, "n": 4},
              "counter:rounds": 4.0}
    return [
        h.BenchRecord("full_sort_u32", 268435456, 3, 0.0153, 0.0154, 2.1e-5, 1.75e10,
                      extra={"strategy": "auto"}),
        h.BenchRecord("storage_mem_local_w8", 1 << 20, 1, 1.25, 1.25, 0.0, 838860.8,
                      unit="keys/s", extra={"phases": phases, "nworker": 2}),
        h.BenchRecord("kv_sort_u32_p64B", 7, 2, 0.0, 0.0, 0.0, 0.0, unit="rows/s"),
    ]


def test_report_text_matches_jax():
    want, got = _records(jh), _records(th)
    assert [r.line() for r in got] == [r.line() for r in want]
    assert th.report(got) == jh.report(want)
    assert th.report(got, as_json=True) == jh.report(want, as_json=True)
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]


def _analyze_files(tmp_path):
    """The JAX package's analyze fixture (tests/test_cli_bench.py)."""
    def rec(name, rate, phases=None):
        r = th.BenchRecord(name=name, n=1000, reps=2, median_s=1e-3, mean_s=1e-3,
                           stdev_s=0.0, rate_per_s=rate,
                           extra={"phases": phases} if phases else {})
        return json.dumps(r.to_dict())

    r1, r2 = tmp_path / "r1.jsonl", tmp_path / "r2.jsonl"
    phases = {"workers": {"total_s": 0.08, "mean_s": 0.02, "stdev_s": 0.0, "n": 4},
              "split": {"total_s": 0.02, "mean_s": 0.005, "stdev_s": 0.0, "n": 4}}
    r1.write_text(rec("full_sort", 100e6, phases) + "\n")
    r2.write_text(rec("full_sort", 150e6) + "\n" + rec("new_bench", 5e6))
    return str(r1), str(r2)


@pytest.mark.parametrize("which", [["r1"], ["r1", "r2"], ["r2", "r1"], ["r1", "r1"]])
def test_analyze_matches_jax(which, tmp_path, capsys):
    files = dict(zip(("r1", "r2"), _analyze_files(tmp_path)))
    argv = ["analyze", *(files[w] for w in which)]
    assert jax_cli(argv) == 0
    want = capsys.readouterr().out
    assert port_cli(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    if which == ["r1"]:
        assert "workers" in got and "80.0%" in got
    if which == ["r1", "r2"]:
        assert "1.50x" in got and "new_bench" in got
    if which == ["r1", "r1"]:
        assert "1.00x" in got


def test_analyze_rejects_bad_arguments(capsys):
    assert ta.main([]) == 2
    assert ta.main(["a", "b", "c"]) == 2


def test_cli_bench_writes_a_trace(tmp_path, monkeypatch, capsys):
    """``bench --trace-dir`` on the CPU, with a suite of one real row that
    is traced: the JSON line and a Chrome trace come out."""
    seen = {}

    def suite(name, *, trace_dir=None, device=None):
        seen.update(suite=name, device=device)
        return [th.bench_full_sort(1 << 10, reps=1, trace_dir=trace_dir, device=device)]

    monkeypatch.setattr(th, "run_benchmarks", suite)
    trace_dir = tmp_path / "trace"
    assert port_cli(["bench", "--suite", "full", "--json", "--device", "cpu",
                     "--trace-dir", str(trace_dir)]) == 0
    assert seen == {"suite": "full", "device": "cpu"}
    rec = json.loads(capsys.readouterr().out)
    assert rec["name"] == "full_sort_u32" and rec["n"] == 1 << 10 and rec["median_s"] > 0
    traces = list(trace_dir.iterdir())
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]


def test_device_time_on_the_cpu_uses_the_host_clock():
    calls = []

    def fn(x):
        calls.append(x)
        return x + 1

    med, mean, sd, out = th.device_time(fn, (torch.zeros(4),), reps=3, warmup=2)
    assert len(calls) == 5 and out.tolist() == [1.0] * 4
    assert med > 0 and mean > 0 and sd >= 0


class _FakeEvent:
    """torch.cuda.Event on the host clock, for the timer's choice on the CPU."""

    recorded = []

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self, stream):
        self.stream = stream
        self.at = time.perf_counter()
        _FakeEvent.recorded.append(stream)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3


@pytest.mark.parametrize("clock", ["events", "synchronise", "two_cards"])
def test_device_time_picks_its_clock(clock, monkeypatch):
    """One card's tensors: CUDA events on its stream around each rep; a mesh
    row's devices: a synchronise of each distinct card around each rep;
    tensors on two cards without the row's devices: refused."""
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    synced = []
    _FakeEvent.recorded = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: f"stream of {device}")
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    fn = lambda *args: len(args)  # noqa: E731 -- stands for a row's call
    if clock == "events":
        med, _, _, out = th.device_time(fn, ([cuda0], cuda0), reps=3)
        assert _FakeEvent.recorded == ["stream of cuda:0"] * 6
        assert synced == [cuda0]  # after the warmup only
    elif clock == "synchronise":
        med, _, _, out = th.device_time(fn, (1, 2), reps=3, devices=(cuda0, cuda1, cuda0))
        assert not _FakeEvent.recorded
        assert synced == [cuda0, cuda1] * 4  # after the warmup and each rep
    else:
        with pytest.raises(ValueError, match="span"):
            th.device_time(fn, ([cuda0, cuda1],), reps=1)
        return
    assert out == 2 and med >= 0
