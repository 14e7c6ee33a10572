"""Settings of the benchmark's own tests: the repository root on the
path, one CPU thread a process, and the ``cuda`` marker for tests that
need a card (they decide inside the test whether one exists)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("TOPOPTEVAL_VERBOSE", "0")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where "
        "torch.cuda.is_available() is false)")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
