"""The benchmark's tests: ``python -m pytest benchmark/tests -q`` (the card's
cases with ``-m cuda`` on a machine with one)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped where torch sees none")


@pytest.fixture
def card():
    """The CUDA device, or a skip where torch sees none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch sees no CUDA device")
    return torch.device("cuda")
