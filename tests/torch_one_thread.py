"""One torch thread for the tests of a file: ``from torch_one_thread
import one_torch_thread`` (an autouse fixture, so importing it is using it).

The Tier-1 run gives each of its 6 workers a test file at a time, and by
default each worker's torch ops spread over every core of the host, 48
threads on 8 cores; the port's tiny models run their many small ops far
faster on one thread there (the heaviest port files took a third of the
time on one).  The fixture gives the process its thread count back after
the file.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
