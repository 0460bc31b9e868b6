"""The FL round's phases in a traced window.

``Federation.run`` marks four of each round's phases as ``record_function``
ranges, one after another, never nested: ``fl.shuffle``, ``fl.server``,
``fl.eval``, ``fl.readback``.  The local phase has no range of its own (a
range open over its launches slows each one under the profiler): it is
the gap from a round's ``fl.shuffle`` end to its ``fl.server`` start
(:func:`local_phase`).  The ranges land among a :class:`profile.Trace`'s
host events, on the clock of its device records, so a phase's device busy
and idle time is the overlap of its intervals with the device's busy
intervals.  A program without the ranges gives no intervals, and the
readers built on these functions then read nothing.
"""
from __future__ import annotations

from portbench.harness import profile

#: the host calls that launch a kernel (the runtime's and the driver's)
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def spans(tr: profile.Trace, name: str) -> list[tuple[float, float]]:
    """The (start, end) of every host span named ``name``, by start."""
    return sorted((s, e) for n, s, e in tr.host if n == name)


def local_phase(tr: profile.Trace) -> list[tuple[float, float]]:
    """Each round's local phase, (``fl.shuffle``'s end, ``fl.server``'s
    start); empty where the trace lacks the spans or they do not pair."""
    shuffles, servers = spans(tr, "fl.shuffle"), spans(tr, "fl.server")
    if len(shuffles) != len(servers):
        return []
    return [(a[1], b[0]) for a, b in zip(shuffles, servers)]


def overlap(a: list[tuple[float, float]],
            b: list[tuple[float, float]]) -> float:
    """Seconds that two lists of sorted, disjoint intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def busy(tr: profile.Trace) -> list[tuple[float, float]]:
    """The device's busy intervals (the union of its records)."""
    return profile._merged((r[1], r[2]) for r in tr.device)


def idle_in(tr: profile.Trace,
            intervals: list[tuple[float, float]]) -> float | None:
    """Seconds with no device activity inside ``intervals`` (sorted,
    disjoint), or None where there are none."""
    if not intervals:
        return None
    return sum(e - s for s, e in intervals) - overlap(intervals, busy(tr))


def per_round_ms(tr: profile.Trace, secs: float | None) -> float | None:
    """Seconds over the window's rounds, in ms (None stays None)."""
    if secs is None or tr.steps <= 0:
        return None
    return 1e3 * secs / tr.steps
