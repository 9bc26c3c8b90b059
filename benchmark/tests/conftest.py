"""The benchmark's tests: ``python -m pytest benchmark/tests`` from the
repository's root. Tests marked ``card`` need a CUDA device; the
``card`` fixture skips them without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at a cell's own size on the card")
    return torch.device("cuda", 0)
