"""The benchmark's CPU tests.  Run from the root of the repository:

    python -m pytest -q portbench/tests

Tests marked ``card`` need a CUDA device and skip without one.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)




def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
