"""One torch thread while a port test module runs.

The suite runs several test processes on the machine's cores.  Each torch
process keeps a pool of OpenMP threads that spin between parallel regions,
and the spinning slows every process on the machine, while the tests'
shapes are too small to gain from more than one thread.  A test module
imports ``one_torch_thread`` (an autouse fixture) to run on one thread;
the count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
