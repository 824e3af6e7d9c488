"""One intra-op thread for the port's CPU tests.

The tier-1 command runs the suite in six pytest-xdist workers on one host.
torch's default of one intra-op thread a core then puts six processes'
worth of spinning threads on every core, and a small op waits for all of
them: ``test_torch_port_kilonerf.py::test_fit_resume_and_serve_kilonerf``
takes 2 s alone and took 349 s in such a run. A port test module imports
``one_intra_op_thread``, which runs the module (its module-scoped fixtures
too) on one thread and restores the count after it.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
