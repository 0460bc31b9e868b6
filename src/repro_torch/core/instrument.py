"""W-pass accounting for the coalition round.

The round's first-order cost is how many times the (N, D) client weight
matrix streams out of device memory.  Each streaming composition in
:mod:`repro_torch.core.distance` / :mod:`repro_torch.core.fused` calls
:func:`count_w_pass` once per full sweep over W as it runs (PyTorch runs
eagerly, so the count is taken at call time rather than trace time).

Only full (N, D) sweeps are counted; the (K, D) center gather and barycenter
re-reads of the composed path are K/N-sized and left out, as in the
reference.  An S-wide sweep over a sketch is not a W pass either: the
sketched round runs the backend's distance primitives on the (N, S) sketch
under :func:`suspend_w_passes`.  The running total is a
:class:`contextvars.ContextVar`, so nested :func:`count_w_passes` blocks each
see their own delta.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator

_W_PASSES: contextvars.ContextVar[int] = contextvars.ContextVar(
    "repro_torch_w_passes", default=0)
_SUSPENDED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_w_passes_suspended", default=False)


def count_w_pass(n: int = 1) -> None:
    """Record ``n`` full sweeps over the (N, D) weight matrix."""
    if _SUSPENDED.get():
        return
    _W_PASSES.set(_W_PASSES.get() + n)


@contextlib.contextmanager
def suspend_w_passes() -> Iterator[None]:
    """Make :func:`count_w_pass` a no-op inside the block (sweeps over the
    (N, S) sketch, which are not W passes)."""
    tok = _SUSPENDED.set(True)
    try:
        yield
    finally:
        _SUSPENDED.reset(tok)


@contextlib.contextmanager
def count_w_passes() -> Iterator[Callable[[], int]]:
    """Count sweeps made inside the block::

        with instrument.count_w_passes() as passes:
            coalitions.run_round(w, state)
        assert passes() == 2
    """
    start = _W_PASSES.get()
    yield lambda: _W_PASSES.get() - start
