"""One PyTorch intra-op thread for the port's CPU test files.

The suite runs in several worker processes (``-n 6``) on a machine of a few
cores, and PyTorch's default of an intra-op thread a core oversubscribes
them: the port's small tensor ops then spend most of their time waiting on
each other's threads (PERF.md section 6, PR 32: the port's files took 724 s
of wall time on the seed's tree and 223 s with one thread each).  A test
file takes the fixture by importing it,

    from test_torch_cpu_threads import one_torch_thread  # noqa: F401

which runs its tests on one thread and restores the count after them, so
a file that does not import it runs as before whatever ran in its worker
first.  One thread also sums in one fixed order.
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests, the count restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_the_module_runs_on_one_thread():
    assert torch.get_num_threads() == 1

