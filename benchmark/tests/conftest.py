"""The benchmark's own tests: the benchmark's folder and the repo root on
sys.path, and the `cuda` fixture that skips a test without a card."""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
