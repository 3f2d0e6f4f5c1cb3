"""Share the host's cores among pytest-xdist workers in the port's tests.

torch sizes its intra-op thread pool to every core of the host in each
process, so six workers run six pools of that size on one host's cores. The
pools' threads then wait at OpenMP barriers for threads the kernel has
descheduled, and a tiny training step that takes under a second alone takes
a hundred times longer beside the other workers. Each test module of the port
imports :func:`share_cores_among_workers`, which gives torch its share of
the cores while the module runs (all of them outside xdist) and restores the
pool's size after.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def share_cores_among_workers():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(workers, 1)))
    yield
    torch.set_num_threads(before)
