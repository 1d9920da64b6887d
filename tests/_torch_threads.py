"""One torch thread for a test module.

The tier-1 command runs the tests in six processes (pytest-xdist `-n 6`)
on one machine: torch's default of a thread a core then oversubscribes the
cores, and its thread pools spin while their threads wait for a core (a
file of small torch operations ran nine times slower so than alone). A module imports `one_torch_thread`
to run its torch operations on one thread; its numbers do not change.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
