"""The benchmark's own tests: ``python -m pytest sortbench/tests -q``.

Most run on the CPU, where the port's entries run their kernels' plain
versions at a small size.  Tests marked ``card`` need CUDA; they decide so
inside the ``cuda_devices`` fixture and skip there when there is no card.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_devices():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
