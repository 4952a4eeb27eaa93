"""A fixture that runs torch on one thread in the tests that use it, for
Tier-1's time.

Tier-1 runs six pytest workers on the machine's cores.  torch's default of
one intra-op thread per core then oversubscribes them, and every parallel
region of the many small operations of a small fit waits on threads that
are not running: under five busy neighbours, one example's test took 157 s
with the default threads and 17 s on one (``tests/test_torch_examples.py``),
and ``test_torch_minibatch`` took 800 test-seconds in a Tier-1 run against
43 s alone.  Tests whose operations are large (a 192 x 256 image's
convolutions) keep the default.  One thread computes the same results;
the float64 comparisons hold at their tolerances either way.
"""

import pytest
import torch


@pytest.fixture
def one_torch_thread():
    """``torch.set_num_threads(1)`` for the test, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
