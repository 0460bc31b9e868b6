"""Helpers for the port's test processes.

:func:`cap_cpu_threads` keeps parallel test workers from oversubscribing the
host: each pytest-xdist worker would otherwise start torch's default number
of intra-op threads (one per core), so six workers on eight cores run 48
busy threads and a test that takes seconds alone takes minutes.
"""
from __future__ import annotations

import contextlib
import os

import torch


def cap_cpu_threads() -> int:
    """Cap torch's intra-op and inter-op threads at the host's cores shared
    out over the xdist workers (``PYTEST_XDIST_WORKER_COUNT``), at least 1.

    The inter-op pool can be sized only once per process and only before
    it first runs, so a second call (another test file in the same worker)
    leaves it as it is.  ``OMP_NUM_THREADS`` is set as well, so processes
    the tests start inherit the cap.  Returns the thread count.
    """
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // max(workers, 1))
    os.environ["OMP_NUM_THREADS"] = str(n)
    torch.set_num_threads(n)
    try:
        torch.set_num_interop_threads(n)
    except RuntimeError:     # already set, or the pool has already run
        pass
    return n


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the block with ``n`` intra-op threads, then restore the count:
    for a test whose floating-point result depends on how CPU kernels
    split their sums over threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
