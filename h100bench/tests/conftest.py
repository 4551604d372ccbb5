"""Tests of the H100 benchmark; run from the repository's root with
``python -m pytest h100bench/tests -q``. Tests that need the card carry
the ``cuda`` marker and skip inside the ``cuda_device`` fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
