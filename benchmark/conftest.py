"""pytest set-up of the benchmark's own tests: the benchmark's modules and the
program import by their top-level names, and the `card` marker."""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one (run on the card with -m card)")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
