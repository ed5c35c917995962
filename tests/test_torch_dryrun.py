"""The port's dryrun (gpu_radix_sort_tpu_torch/dryrun.py), the counterpart of
the JAX repository's ``__graft_entry__.py``: ``entry`` against JAX's
``entry`` (the same example keys; the port's step sorts them), and
``dryrun_multichip(8, device="cpu")`` at the JAX dryrun's seeds and sizes,
which must run all nine of its checks.  JAX's ``dryrun_multichip`` is not
called: it runs JAX's Pallas RDMA kernels in interpret mode."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu_torch import dryrun

REPO = Path(__file__).resolve().parent.parent
CHECKS = [
    "distributed LSD sort", "stable kv sample sort", "64-bit distributed sort",
    "64-bit kv distributed sort", "hash aggregate", "overflow-exchange sort",
    "width-16 fused sort", "rdma-exchange sort", "rdma-overlap sort (4 ranks)",
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_graft_entry():
    spec = importlib.util.spec_from_file_location("graft_entry", REPO / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_entry_matches_jax_and_sorts():
    fn, (example,) = dryrun.entry("cpu")
    _, (jax_example,) = _jax_graft_entry().entry()
    assert example.dtype == torch.uint32 and example.numel() == 1 << 20
    np.testing.assert_array_equal(example.numpy(), np.asarray(jax_example))
    np.testing.assert_array_equal(fn(example).numpy(), np.sort(example.numpy()))


def test_dryrun_multichip_runs_every_check_on_eight_cpu_ranks(capsys):
    assert dryrun.dryrun_multichip(8, device="cpu") == CHECKS
    line = capsys.readouterr().out.strip()
    assert line.startswith("dryrun_multichip(8): distributed LSD sort,")
    assert line.endswith("all exact over a 8-rank mesh on ['cpu']")


def test_dryrun_multichip_raises_on_a_mismatch(monkeypatch):
    class Unsorted(dryrun.DistributedSortPipeline):
        def build(self):
            fn, args = super().build()
            return (lambda shards: (shards, fn(shards)[1])), args

    monkeypatch.setattr(dryrun, "DistributedSortPipeline", Unsorted)
    with pytest.raises(AssertionError, match="distributed LSD sort mismatch"):
        dryrun.dryrun_multichip(8, device="cpu")


def test_dryrun_multichip_needs_a_card_unless_told_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(8)
