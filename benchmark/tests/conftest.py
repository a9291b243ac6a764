"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
`cuda` that need the card (they skip elsewhere).

    python -m pytest -q -p no:cacheprovider benchmark/tests            # here
    python3 -m pytest -q -p no:cacheprovider benchmark/tests -m cuda    # on the card
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
