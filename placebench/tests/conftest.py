"""The benchmark's tests: on the CPU at tiny sizes, and (marked ``cuda``)
on the card at the cells' own sizes.

    python -m pytest placebench/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where torch has no CUDA device)")


@pytest.fixture
def cuda():
    """Skip unless torch sees a CUDA device (asked here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's cells run on the card")
    return torch.device("cuda")
