"""The ``one_thread`` fixture of the port's tests (not collected): one
intra-op thread for torch while a test runs.  The smoke shapes gain
nothing from more, and the suite runs several workers at once, whose
thread pools would otherwise contend for the same cores."""
import pytest
import torch


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
