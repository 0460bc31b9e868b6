"""What a run hands back to ``run.py``, and the bookkeeping of the
comparison that decides ``correct``.

A driver returns an :class:`Outcome`: the end-to-end values it measured,
the context its per-layer readers read, the device's peak memory and a
``verify`` callable.  ``verify`` runs once the window has closed and the
peak has been read: it frees the program's state, runs the plain
reference and returns a :class:`Checks`, each number beside its limit from
the cell's ``workloads/<cell>.json``.  A number passes when it is finite
and at most its limit; a limit that is null (not yet set from readings)
passes nothing.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Callable


class Checks:
    """The numbers compared, each with the cell's limit for it."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.items: list[tuple[str, float, float]] = []
        #: what the comparison saw beside the numbers (printed before them)
        self.notes: list[str] = []

    def add(self, name: str, value: float) -> None:
        limit = self.limits[name]
        self.items.append((name, float(value),
                           math.nan if limit is None else float(limit)))

    @staticmethod
    def _ok(value: float, limit: float) -> bool:
        return math.isfinite(value) and value <= limit

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(self._ok(v, lim)
                                        for _, v, lim in self.items)

    def lines(self) -> list[str]:
        return self.notes + [
            f"check {n} = {v!r} limit {lim!r} "
            f"{'ok' if self._ok(v, lim) else 'FAIL'}"
            for n, v, lim in self.items]

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.items}


@dataclasses.dataclass
class Outcome:
    """One run of a cell, as a driver hands it back."""

    attempted: int
    failed: int
    #: end-to-end metric name -> value (the cell's, from the untraced run)
    end_to_end: dict
    #: what the per-layer readers read: the traced window (``trace``),
    #: the window's timings, the cell and its shapes
    ctx: dict
    memory_peak_bytes: int
    verify: Callable[[], Checks]


def by_leaf(gap: dict, ref: dict, skip=()) -> dict:
    """Each leaf's ``gap`` against the larger of that leaf's reference
    value and the median leaf's (scalars by leaf name; ``skip`` leaves
    left out)."""
    med = statistics.median(ref.values())
    return {k: gap[k] / max(ref[k], med, 1e-30) for k in ref
            if k not in skip}


def worst_leaf(gap: dict, ref: dict, skip=()) -> float:
    """The largest of :func:`by_leaf`."""
    return max(by_leaf(gap, ref, skip).values())


def worst(gaps: dict, n: int = 3) -> str:
    """The ``n`` largest of a leaf -> gap dict, as text."""
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{k} {v:.3g}" for k, v in top)
