"""One torch intra-op thread while a port test module runs.

The suite runs several pytest workers on one machine.  Each torch process
would otherwise start one intra-op thread per core, and the workers' threads
then oversubscribe the cores: the port's test files measured 2-5x slower
under a 5-worker run than with one thread each.  Their tensors are small, so
one thread is enough.  A test module opts in by importing the fixture.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
