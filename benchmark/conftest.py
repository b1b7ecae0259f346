"""Tests of the benchmark's harness. Run from the root of the checkout:

    python3 -m pytest benchmark/tests -q            # on the CPU
    python3 -m pytest benchmark/tests -q -m card    # on a card

Tests marked `card` need a CUDA card; they decide inside the `card`
fixture, when they run, whether one is there, and skip without it.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)
