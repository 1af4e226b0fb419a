"""The benchmark's tests: the harness on the host at small sizes, with the
port's plain versions in place of its CUDA kernels.

``cuda`` marks a test that needs a card; whether there is one is decided
inside the test's fixture, never while a module is imported."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
