"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests -q``). Tests that need a CUDA card carry the ``card`` marker
and take the ``card`` fixture, which skips them where there is none; run
them on the card with ``python -m pytest portbench/tests -q -m card``."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the program's kernels")
    return torch.device("cuda", 0)
