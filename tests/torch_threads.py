"""One intra-op thread for the port's in-process CPU tests.

torch splits each CPU op over an OpenMP pool of a thread per core. The
tests' ops are small and many, and on a host whose cores are shared (a
virtual machine whose CPUs are taken away now and then) every parallel
region waits for its slowest thread: in one process after the earlier
modules, the tf32 backward files took 36.7 and 39.8 s on the pool
against 14.6 and 7.6 s on one thread (the same tests, inputs and
bounds). A module imports ``one_torch_thread`` (an autouse fixture) to
run on one thread; the count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
