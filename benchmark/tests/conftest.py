"""The benchmark's own CPU tests: its directory on the import path, and a
marker for the tests that need a CUDA card (they skip here, deciding inside
the test)."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _few_threads():
    """The plain kernel versions run many tiny ops: few threads a worker."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
