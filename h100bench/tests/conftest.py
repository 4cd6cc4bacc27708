"""CPU tests of the benchmark's yardstick, its reference and its harness,
at tiny sizes.  Tests marked ``cuda`` need a CUDA card and skip without
one; on the card run them with

    python -m pytest -p no:cacheprovider h100bench/tests -m cuda
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
CHECKOUT = BENCH.parent
for p in (str(BENCH), str(CHECKOUT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
