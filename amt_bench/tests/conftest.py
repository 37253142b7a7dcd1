"""Tests of the benchmark itself: ``python -m pytest amt_bench/tests`` on
the CPU; ``python -m pytest amt_bench/tests -m card`` on a machine with a
card (those tests skip here)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _threads():
    import torch

    torch.set_num_threads(2)
