"""Two torch intra-op threads for the port's CPU tests.

The suite runs in several worker processes on one host, and torch's default
of one intra-op thread per core in each of them makes the workers contend
for the cores; the tensors of these tests are small, so a worker gains
nothing from more threads. A test module takes the setting by importing the
fixture:

    from torch_threads import torch_threads  # noqa: F401

It holds for the module's tests and is undone after them.
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    was = torch.get_num_threads()
    torch.set_num_threads(min(THREADS, was))
    yield
    torch.set_num_threads(was)
