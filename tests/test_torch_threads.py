"""``one_thread``, a module-scoped autouse fixture for the port's test
files that run torch arithmetic on the CPU: it caps torch's intra-op
threads at 1 for the module's tests and puts the count back after. The
tier-1 run has six pytest-xdist workers on eight CPUs; at torch's default
of one thread a CPU in each, the workers' threads fight for the CPUs and a
test that takes seconds alone takes minutes. It changes how many threads
run the tests' arithmetic, not what they check. A test file takes it
with ``from test_torch_threads import one_thread  # noqa: F401``."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_thread_caps_torch_at_one_thread():
    assert torch.get_num_threads() == 1
    x = torch.arange(1 << 16, dtype=torch.float64).reshape(256, 256)
    assert float((x @ x.T).trace()) == float((x * x).sum())
