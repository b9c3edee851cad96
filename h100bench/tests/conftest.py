"""The benchmark's own tests: run from the checkout's root with
`python -m pytest h100bench/tests -q` (CPU), and on the card with
`python -m pytest h100bench/tests -q -m cuda`."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, never
    at import time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
