"""A fixture the port's slower CPU test modules share: import
``_one_torch_thread`` by name into a module to run its torch CPU ops on
one thread."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU ops on one thread in the importing module: beside the
    suite's other workers its thread pool oversubscribes the cores (the
    reduced moonshot's init took 46.3 s on 8 threads, 1.1 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
