"""Fixtures of the benchmark's own tests (``python -m pytest
portbench/tests``): a checkout of tiny cells on the CPU, and the card
check, decided inside a fixture."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.tests import tiny  # noqa: E402


@pytest.fixture
def tiny_root(tmp_path):
    return tiny.make_root(tmp_path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
