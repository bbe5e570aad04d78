"""Tests of the benchmark harness. They run on CPU tensors at small scale
factors; a test marked `card` needs a CUDA device and skips without one
(decided in the `card` fixture, at run time). On the card:

    python3 -m pytest tpch_bench_gpu/tests -m card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
