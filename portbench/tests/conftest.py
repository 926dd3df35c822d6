"""The benchmark's CPU tests. Tests marked ``card`` need an NVIDIA card:
they decide inside a fixture whether one is there and skip without it.

    python3 -m pytest portbench/tests -q              # here, on the CPU
    python3 -m pytest portbench/tests -q -m card      # on the card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
