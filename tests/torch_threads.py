"""The port's tests' one-thread fixture (no JAX import: any test file may
take it)."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs on one CPU thread in these tests: its tensors
    are tiny, and the pytest-xdist workers' thread pools would otherwise
    contend for the cores (a test that takes 2 s alone took 80 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
