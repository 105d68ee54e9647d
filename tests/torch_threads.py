"""One PyTorch thread for the port's model tests.

The test run spreads the files over several worker processes on one host,
and each worker's PyTorch would otherwise start a thread per core: so
oversubscribed, the reduced models' many small CPU ops wait on each
other's threads (reduced jamba's gradient case took 328 s in a 6-worker
run, against 15 s alone).  A test module takes the fixture by importing
it: ``from torch_threads import one_torch_thread  # noqa: F401``.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
