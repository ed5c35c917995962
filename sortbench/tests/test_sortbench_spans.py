"""The trace put down to the port's spans (``sortbench/spans.py``), on
made-up events that carry correlation ids, and on traced CPU runs."""

from dataclasses import dataclass

import pytest
import torch

from sortbench import cells, harness, run, spans, trace

from .helpers import run_small
from .test_sortbench_trace import EVENTS, MS, Ev


@dataclass
class Linked(Ev):
    corr: int = 0
    linked: int = 0

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked


def ms(x):
    return int(x * MS)


def U(name, t0, t1):
    return Linked("user_annotation", name, ms(t0), ms(t1))


def R(name, t0, t1, corr):
    return Linked("cuda_runtime", name, ms(t0), ms(t1), corr=corr)


def K(name, t0, t1, dev=0, corr=0, linked=0, kind="kernel"):
    return Linked(kind, name, ms(t0), ms(t1), dev=dev, corr=corr, linked=linked)


# two calls; the first runs a mesh sort of two rounds, the second no program span
LINKED = [
    U(trace.CALL, 0, 10), U(trace.WAIT, 10, 20), U(trace.CALL, 20, 30), U(trace.WAIT, 30, 40),
    U("grs.mesh_sort", 0.5, 9.5), U("grs.round", 1, 5), U("grs.exchange", 3, 4.5),
    U("grs.round", 5, 9),
    R("cudaLaunchKernel", 1.2, 1.3, 101), K("void foo_kernel(int)", 1.5, 3.5, corr=101),
    R("cudaMemcpyAsync", 3.2, 3.3, 102),
    K("Memcpy PtoP (Device -> Device)", 3.5, 5.5, dev=1, corr=102, kind="gpu_memcpy"),
    Linked("cpu_op", "aten::empty", ms(4.6), ms(4.9), corr=101),  # PyTorch's own ids
    R("cudaLaunchKernel", 5.5, 5.6, 103), K("bar_kernel", 6, 8, corr=103),
    Linked("cpu_op", "aten::add", ms(6.5), ms(6.7), corr=7),
    K("baz_kernel", 8, 9, corr=104, linked=7),  # its launch is not in the trace: the op's
    K("lonely_kernel", 9, 9.5, dev=1),  # no correlation id
    R("cudaStreamSynchronize", 7, 8.5, 106),
    R("cudaStreamSynchronize", 10, 20, 107),  # the harness's own wait
    R("cudaLaunchKernel", 21, 21.1, 105), K("qux_kernel", 21.5, 22.5, corr=105),
    R("cudaStreamSynchronize", 22, 23, 108),
    Linked("gpu_user_annotation", "grs.round", ms(1.5), ms(3.5)),
]


def test_device_time_and_host_waits_go_to_the_innermost_span():
    sp = spans.split(LINKED, [0, 1])
    assert sp.calls == 2
    assert sp.device_s == pytest.approx({("grs.round", 0): 0.005, ("grs.exchange", 1): 0.002,
                                         (None, 1): 0.0005, (None, 0): 0.001})
    assert sp.host_wait_s == pytest.approx({"grs.round": 0.0015, None: 0.001})
    assert sp.spans == {"grs.mesh_sort": 1, "grs.round": 2, "grs.exchange": 1}


class Untyped:
    """An event of a release with no ``activity_type``: only the device
    type and whether it is a user's annotation."""

    def __init__(self, e):
        self.e = e

    def __getattr__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return getattr(self.e, name)

    def device_type(self):
        on_card = self.e.kind not in ("user_annotation", "cpu_op", "cuda_runtime")
        return torch.autograd.DeviceType.CUDA if on_card else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self.e.kind.endswith("user_annotation")


def test_a_release_without_activity_types_splits_the_same():
    assert not hasattr(Untyped(LINKED[0]), "activity_type")
    got, want = spans.split(map(Untyped, LINKED), [0, 1]), spans.split(LINKED, [0, 1])
    assert got == want


def test_the_four_figures():
    rep = spans.split(LINKED, [0, 1]).report()
    assert rep["host_wait_ms"] == pytest.approx(0.75)
    assert rep["round_ops_ms"] == pytest.approx(2.5)
    assert rep["exchange_step_ms"] == pytest.approx(1.0)
    assert rep["stage_a_ms"] is None
    assert rep["attributed_pct"] == pytest.approx(100 * 5 / 6)
    assert rep["spans_per_call"] == {"grs.exchange": 0.5, "grs.mesh_sort": 0.5, "grs.round": 1.0}
    assert rep["device_ms_per_call"]["grs.round"] == pytest.approx({0: 2.5})
    assert rep["host_wait_ms_per_call"] == pytest.approx({"grs.round": 0.75, "None": 0.5})


def test_stage_a_figure():
    events = [U(trace.CALL, 0, 10), U(trace.WAIT, 10, 12), U("grs.sort_partial", 0, 9),
              U("grs.binning.stage_a", 1, 4), U("grs.boundaries", 5, 6),
              R("cudaLaunchKernel", 2, 2.1, 1), K("sort_kernel", 2.5, 6.5, corr=1),
              R("cudaLaunchKernel", 5.5, 5.6, 2), K("where_kernel", 6.5, 7, corr=2)]
    rep = spans.split(events, [0]).report()
    assert rep["stage_a_ms"] == pytest.approx(4.0)
    assert rep["device_ms_per_call"]["grs.boundaries"] == pytest.approx({0: 0.5})
    assert rep["host_wait_ms"] == 0.0 and rep["attributed_pct"] == pytest.approx(100)


def test_gap_labels_gain_the_span():
    got = dict(spans.split(LINKED, [0, 1]).gaps)
    assert got == pytest.approx({
        "cuda:1/sortbench.call/idle": 0.0305,
        "cuda:0/sortbench.wait/idle": 0.0175,
        "cuda:0/sortbench.wait/cudaStreamSynchronize": 0.0125,
        "cuda:1/sortbench.call/grs.round/idle": 0.0035,
        "cuda:1/sortbench.call/grs.round/cudaStreamSynchronize": 0.0035,
        "cuda:0/sortbench.call/grs.round/aten::empty": 0.0025,
        "cuda:0/sortbench.call/grs.mesh_sort/idle": 0.0015,
    })


def test_no_program_span_no_figure():
    sp = spans.split(EVENTS, [0, 1])
    rep = sp.report()
    for name in ("host_wait_ms", "stage_a_ms", "exchange_step_ms", "round_ops_ms"):
        assert rep[name] is None, name
    assert set(sp.device_s) == {(None, 0), (None, 1)} and rep["attributed_pct"] == 0.0
    assert [label for label, _ in sp.gaps] == [label for label, _ in trace.reduce(EVENTS, [0, 1]).gaps]


def test_events_without_correlation_ids_are_not_put_down():
    plain = [Ev(e.kind, e.name_, e.t0, e.t1, e.dev, e.thread) for e in LINKED]
    sp = spans.split(plain, [0, 1])
    assert {name for name, _ in sp.device_s} == {None}
    assert sp.host_wait_s == pytest.approx({"grs.round": 0.0015, None: 0.001})


def _readers(events):
    cell = cells.load("u32_1Gi_4card.lsd_w8")
    run = harness.Run(cell, "NVIDIA H100 80GB HBM3", 1.0, 0.04, 2,
                      call_ms=[20.0, 20.0], enqueue_ms=[10.0, 10.0],
                      bytes_per_card=2 * 10**9, trace=trace.reduce(events, [0, 1]))
    return {m.name: cells.reader(cell, m).read(run) for m in cell.per_layer}


def test_existing_readers_read_the_same_with_program_spans():
    program = [Ev("user_annotation", "grs.mesh_sort", 0, 9 * MS),
               Ev("user_annotation", "grs.round", MS // 2, 6 * MS),
               Ev("user_annotation", "grs.exchange", 2 * MS, 5 * MS),
               Ev("gpu_user_annotation", "grs.round", 1 * MS, 5 * MS),
               Ev("user_annotation", "grs.round", 20 * MS, 29 * MS)]
    assert _readers(EVENTS + program) == _readers(EVENTS)
    assert None not in _readers(EVENTS).values()


def test_a_traced_cpu_run_opens_the_spans_of_its_entry():
    reduce = trace.reduce
    with spans.splitting() as found:
        line = run_small("u32_256Mi_1card.partial_w8", traced=True, seconds=0.1,
                         keys_per_card=1 << 15)  # past one block: binning passes
    assert trace.reduce is reduce and line["correct"] is True
    rep = found[0]
    assert rep["calls"] == line["attempted"]
    assert rep["spans_per_call"] == {"grs.binning.place": 2, "grs.binning.stage_a": 2,
                                     "grs.boundaries": 1, "grs.sort_partial": 1}
    assert rep["host_wait_ms"] == 0.0 and rep["stage_a_ms"] is None  # no card, no device op


def test_a_traced_cpu_mesh_run_opens_rounds_and_exchanges():
    with spans.splitting() as found:
        line = run_small("u32_1Gi_4card.lsd_w8", traced=True, seconds=0.1)
    assert line["correct"] is True
    # at this size "auto" takes the gather exchange: four unfused rounds, each
    # a digit sort of the gathered keys in two binning passes
    assert found[0]["spans_per_call"] == {"grs.binning.place": 8, "grs.binning.stage_a": 8,
                                          "grs.exchange": 4, "grs.mesh_sort": 1,
                                          "grs.round": 4}


def test_main_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert spans.main(["--workload", "u32_256Mi_1card.full", "--seed", "1",
                       "--seconds", "0.1"]) == 2
    assert capsys.readouterr().out == ""


def test_main_fails_where_the_run_is_not_reduced(monkeypatch):
    monkeypatch.setattr(run, "main", lambda argv: 0)  # a harness that bypasses trace.reduce
    with pytest.raises(RuntimeError, match="never called trace.reduce"):
        spans.main(["--workload", "u32_256Mi_1card.full", "--seed", "1", "--seconds", "0.1"])
