"""One intra-op thread for a port test module.

The tier-1 command runs test files in six processes on the same cores;
each process's torch pool defaults to every core, so their threads
oversubscribe the CPU and a file can take several times its time alone
(``tests/test_torch_batched.py``: 128.2 s against 38.8 s). A module imports
the fixture to pin its tests to one thread:

    from tests.torch_threads import one_intra_op_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
