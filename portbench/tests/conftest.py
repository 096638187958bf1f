"""Tests of the benchmark itself. Run: python -m pytest portbench/tests -q
(on the card, `-m card` runs the tests that need one)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """cuda:0, or a skip where the process sees no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
