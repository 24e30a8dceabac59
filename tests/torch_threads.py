"""One intra-op thread for a test module's PyTorch work.

The port's CPU tests run small tensors, and the suite runs in parallel
worker processes (`-n 6 --dist loadfile`).  PyTorch's default intra-op
pool has a thread per core in every worker, so six workers oversubscribe
the machine several times over and spend their time waiting on each
other's threads.  A module that imports :func:`one_torch_thread` runs on
one intra-op thread and restores the previous count after its last
test."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
