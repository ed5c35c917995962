"""The trace's reduction and the device-trace readers, on made-up events
(a CPU run has no device events to read)."""

from dataclasses import dataclass

import pytest

from sortbench import cells, harness, trace


@dataclass
class Ev:
    kind: str
    name_: str
    t0: int
    t1: int
    dev: int = 0
    thread: int = 1

    def activity_type(self):
        return self.kind

    def name(self):
        return self.name_

    def start_ns(self):
        return self.t0

    def end_ns(self):
        return self.t1

    def device_index(self):
        return self.dev

    def start_thread_id(self):
        return self.thread


MS = 1_000_000
EVENTS = [
    # two calls: [0, 10) ms enqueue, [10, 20) wait; [20, 30) and [30, 40)
    Ev("user_annotation", trace.CALL, 0, 10 * MS), Ev("user_annotation", trace.WAIT, 10 * MS, 20 * MS),
    Ev("user_annotation", trace.CALL, 20 * MS, 30 * MS), Ev("user_annotation", trace.WAIT, 30 * MS, 40 * MS),
    Ev("cuda_runtime", "cudaStreamSynchronize", 10 * MS, 20 * MS),
    Ev("cuda_runtime", "cudaLaunchKernel", 20 * MS, 21 * MS),
    Ev("cuda_runtime", "cudaStreamSynchronize", 30 * MS, 40 * MS),
    # card 0: B2 4 ms and a torch kernel 2 ms a call; card 1: a peer copy 3 ms
    Ev("kernel", "(anonymous namespace)::merge_level_kernel(unsigned int const*, long long)", 1 * MS, 5 * MS),
    Ev("kernel", "void at::native::vectorized_elementwise_kernel<4, Foo>(int, Foo)", 5 * MS, 7 * MS),
    Ev("kernel", "(anonymous namespace)::merge_level_kernel(unsigned int const*, long long)", 21 * MS, 25 * MS),
    Ev("kernel", "void at::native::vectorized_elementwise_kernel<4, Foo>(int, Foo)", 25 * MS, 27 * MS),
    Ev("gpu_memcpy", "Memcpy PtoP (Device -> Device)", 2 * MS, 5 * MS, dev=1),
    Ev("gpu_memcpy", "Memcpy PtoP (Device -> Device)", 22 * MS, 25 * MS, dev=1),
    Ev("gpu_user_annotation", trace.CALL, 0, 40 * MS),
    Ev("kernel", "outside the window", 50 * MS, 60 * MS),
    Ev("kernel", "another card", 1 * MS, 39 * MS, dev=7),
]


def test_reduce():
    tr = trace.reduce(EVENTS, [0, 1])
    assert tr.calls == 2 and tr.window_s == pytest.approx(0.040)
    assert tr.busy_s == pytest.approx({0: 0.012, 1: 0.006})
    assert len(tr.ops) == 6
    names = dict(tr.by_name())
    assert names["anon::merge_level_kernel"] == pytest.approx(0.008)
    assert names["Memcpy_PtoP_Device_->_Device"] == pytest.approx(0.006)
    longest = tr.gaps[0]
    assert longest[0] == "cuda:1/sortbench.wait/cudaStreamSynchronize"
    assert longest[1] == pytest.approx(0.017)  # card 1 idle from 5 ms to 22 ms
    assert any(label.startswith("cuda:0/sortbench.wait/") for label, _ in tr.gaps)


def test_device_trace_readers():
    cell = cells.load("u32_1Gi_4card.lsd_w8")
    run = harness.Run(cell, "NVIDIA H100 80GB HBM3", 1.0, 0.04, 2,
                      call_ms=[20.0, 20.0], enqueue_ms=[10.0, 10.0],
                      bytes_per_card=2 * 10**9, trace=trace.reduce(EVENTS, [0, 1]))
    got = {m.name: cells.reader(cell, m).read(run) for m in cell.per_layer}
    assert got["launches_per_call"] == 3
    assert got["torch_ops_pct"] == pytest.approx(100 * 10 / 18)
    assert got["exchange_ms"] == pytest.approx(3.0)
    assert got["device_idle_pct"] == pytest.approx(100 * (1 - 12 / 40))
    assert got["sort_roofline"] == pytest.approx(100 * 2e9 / 3.35e12 / 0.006)
    assert got["host_call_ms"] == 10.0 and got["call_ms_p95.mesh"] == 20.0
    run.kind = "a card the table does not hold"
    assert cells.reader(cell, next(m for m in cell.per_layer
                                   if m.name == "sort_roofline")).read(run) is None


def test_kernel_names_of_the_port():
    names = trace.kernel_names(trace.port_csrc(cells.ROOT))
    assert {"block_sort_kernel", "merge_level_kernel", "binning_kernel",
            "segment_copy_kernel", "group_sort_send_kernel"} <= names
    ex = trace.kernel_names(trace.port_csrc(cells.ROOT), "exchange.cu")
    assert ex == {"segment_copy_kernel", "group_sort_send_kernel"}
    match = trace.matcher(names)
    assert match("(anonymous namespace)::merge_level_kernel(unsigned int const*)")
    assert not match("at::native::merge_level_kernelx")
