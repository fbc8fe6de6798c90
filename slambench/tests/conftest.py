"""The benchmark's own tests. Tests that need a CUDA card carry the ``card``
marker and take the ``card`` fixture, which skips them where there is none
(decided when the test runs, never when a module is imported). Run them on
the card with ``python3 -m pytest slambench/tests -m card``."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
