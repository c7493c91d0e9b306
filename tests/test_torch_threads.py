"""One cap on torch's intra-op threads for every port test process.

Under ``pytest -n N`` each worker's torch would start one intra-op thread
per core, so N workers fight over the cores and a test that takes 3 s
alone takes minutes. Every ``tests/test_torch_*.py`` calls
:func:`cap_torch_threads` when it is imported: the cap is the cores over
the workers (``PYTEST_XDIST_WORKER_COUNT``; one worker outside xdist),
at least 1, the same in every process whichever file it imports first."""
import os

import torch


def torch_thread_cap() -> int:
    """The intra-op thread count of a port test process."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    return max(1, (os.cpu_count() or 1) // max(1, workers))


def cap_torch_threads() -> int:
    """Set torch's intra-op threads to :func:`torch_thread_cap`; returns
    it. Idempotent."""
    cap = torch_thread_cap()
    if torch.get_num_threads() != cap:
        torch.set_num_threads(cap)
    return cap


cap_torch_threads()


def test_the_cap_holds_in_this_process():
    assert torch.get_num_threads() == torch_thread_cap()


def test_the_cap_divides_the_cores_among_the_workers(monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    for workers, want in (("6", 1), ("4", 2), ("1", 8), ("16", 1)):
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", workers)
        assert torch_thread_cap() == want
    monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT")
    assert torch_thread_cap() == 8
