"""One intra-op thread for the port's CPU tests (``tests/test_torch_*.py``).

The tier-1 run spreads the test files over 6 processes on 8 cores. Each process's
default intra-op thread pool (a thread a core) then contends with the other five, and
the port's tests, which run many small torch ops on tiny models, take several times as
long as they do alone. Every port test module imports :func:`one_intra_op_thread`, an
autouse fixture that runs each of its tests on one intra-op thread and restores the
count afterwards.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
