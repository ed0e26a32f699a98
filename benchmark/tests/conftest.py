"""
Test configuration of the benchmark's own tests (benchmark/tests/): the
repository root on sys.path, the `cuda` marker for tests that need an
NVIDIA GPU (they decide inside the test whether one is present). The
helpers the tests share are in bench_helpers.py.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where there is none)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
