"""One torch thread per test process, for the port's test modules, and
a test that the fixture holds.

pytest-xdist runs the suite in several worker processes on one machine.
Torch's default of one intra-op thread per core in each of them
oversubscribes the cores, and its threads' spin-waits then make small CPU
ops one to two orders of magnitude slower. A port test module imports
:func:`one_torch_thread`, so that its tests run torch on one thread; the
JAX reference keeps its own thread pool.
"""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_torch_runs_on_one_thread():
    assert torch.get_num_threads() == 1
