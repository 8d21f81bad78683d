"""The benchmark's own tests: ``python3 -m pytest portbench/tests``.

Tests that need an NVIDIA card carry the ``card`` marker and take the
``card`` fixture, which skips where there is none; the rest run on the
CPU at tiny sizes."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (CUDA); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
