"""The torch thread budget of the port's tests (`tests/test_torch_*.py`)
under pytest-xdist.

Each xdist worker would otherwise run torch on one thread per CPU, and
six such workers on eight cores keep waiting on each other. While a test
of the port runs (its fixtures' setup and teardown included), its worker's
torch runs on `thread_budget()` of `tests/_torch_parallel.py`: the CPUs
split over the workers. Every other test keeps torch's own count."""

import os

import pytest


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item):
    if "PYTEST_XDIST_WORKER_COUNT" not in os.environ or not item.path.name.startswith("test_torch_"):
        yield
        return
    import torch
    from _torch_parallel import thread_budget  # tests/ is on the path once a test module of it is imported

    threads = torch.get_num_threads()
    torch.set_num_threads(thread_budget())
    try:
        yield
    finally:
        torch.set_num_threads(threads)
