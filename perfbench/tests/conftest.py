import pytest


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """The tiny cells' ops are small: one intra-op thread each, so that
    several test workers on one machine do not starve each other (with a
    thread per core each, a tiny train step took seconds)."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
