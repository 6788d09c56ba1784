"""Shared setup of the port's CPU tests (tests/test_torch_*.py).

The tier-1 run shares the CPU among several pytest workers, most of them
busy in JAX. PyTorch's default intra-op pool (one thread per core) then
oversubscribes the machine and slows the port's tests about tenfold, so
each port test module runs with two threads and restores the setting.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
