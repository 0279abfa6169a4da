"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the
root of the repository. They run on the CPU at tiny sizes; those that need
the card carry the ``cuda`` marker and skip without one."""

from pathlib import Path
import sys

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
