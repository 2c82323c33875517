"""The harness's tests: on the CPU at a size a test run holds; the tests
marked ``card`` need the card and skip elsewhere (decided in the fixture)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest vfx_bench/tests -m card)")
    return torch.device("cuda")
