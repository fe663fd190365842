"""Tests of the benchmark harness.  Run from the repository's root:

    python -m pytest bench_port/tests -q

Tests marked ``card`` run only where a CUDA card is present (one H100:
``python -m pytest bench_port/tests -q -m card``) and skip elsewhere."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def one_thread():
    """The plain PyTorch versions run many tiny ops: one thread runs them
    as fast."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
