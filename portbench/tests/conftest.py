"""Shared fixtures of the benchmark's own tests (run on the host: ``python -m pytest portbench/tests -q``;
the cases marked ``chip`` need a CUDA card and skip without one)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips on a host without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
