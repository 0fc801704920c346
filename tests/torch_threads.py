"""The intra-op thread count of the port's CPU tests.

The suite runs several test processes on the machine's cores at once
(pytest-xdist), and torch's default of one intra-op thread a core in each of
them oversubscribes the cores many times over. A test module takes the cap
by importing the fixture:

    from torch_threads import two_threads  # noqa: F401
"""

import pytest
import torch

TEST_THREADS = 2


@pytest.fixture(autouse=True)
def two_threads():
    """TEST_THREADS intra-op threads a test, the count before restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(threads)
