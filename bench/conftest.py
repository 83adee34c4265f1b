"""The benchmark's CPU tests run tiny cells; two threads a test keep them
from crowding the other test workers' cores (restored after each test)."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
