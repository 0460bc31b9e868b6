"""A traced sub-window and what the metrics read from it.

:func:`traced` runs a callable under ``torch.profiler`` (CPU and CUDA
activity), between two synchronisations, inside a ``record_function``
span that marks the window on the profiler's own clock.  The raw events
are read once (``kineto_results.events()``, without building the
profiler's function events) into a :class:`Trace`: the device's activity
(kernels, copies and sets) clipped to the window, and the host's op
events.  The trace file stays in memory: nothing is written to disk.

A CUDA-typed event is device work unless it is an annotation: a
``record_function`` span mirrored onto the device's timeline
(``gpu_user_annotation``), which covers the kernels inside it and would
count them twice.  Such events are told apart by ``activity_type()``
where the profiler has it, else by ``is_user_annotation()``, and are left
out; :meth:`Trace.summary` says how many there were and how the device
records' summed time compares with the busy time.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Callable

import torch

WINDOW = "portbench_window"


@dataclasses.dataclass
class Trace:
    """One traced window.  Times in seconds on the profiler's clock."""

    window_s: float
    #: device activity in the window: (name, start, end, stream), sorted
    #: by start
    device: list[tuple[str, float, float, int]]
    #: host op and runtime events in the window: (name, start, end)
    host: list[tuple[str, float, float]]
    #: steps (or rounds) the window ran, as the driver counts them
    steps: int
    #: CUDA-typed annotation events left out of ``device``
    annotations: int = 0

    def busy_s(self) -> float:
        """Seconds in which some device activity ran (the union of the
        intervals)."""
        return sum(e - s for s, e in _merged((r[1], r[2]) for r in
                                             self.device))

    def device_total(self, pattern: str) -> tuple[float, int]:
        """Total seconds and count of device activity whose name matches
        the regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [e - s for name, s, e, _ in self.device if rx.search(name)]
        return sum(hits), len(hits)

    def kernels(self) -> int:
        """Device activities that are kernels (copies and sets left out)."""
        return sum(1 for name, *_ in self.device
                   if not name.startswith(("Memcpy", "Memset")))

    def host_total(self, names: tuple[str, ...]) -> float:
        """Seconds the host spent inside ops of these names, nested calls
        of the same names counted once (the outermost)."""
        spans = sorted((s, e) for n, s, e in self.host if n in names)
        return sum(e - s for s, e in _merged(spans))

    def summary(self) -> str:
        """The device records' count, their summed and their busy seconds
        (summed above busy: records that overlap, as kernels on two
        streams do), the records on each stream and the annotations left
        out."""
        summed = sum(r[2] - r[1] for r in self.device)
        streams: dict[int, int] = {}
        for rec in self.device:
            streams[rec[3]] = streams.get(rec[3], 0) + 1
        return (f"traced window {self.window_s!r} s: {len(self.device)} "
                f"device records summing to {summed!r} s, busy "
                f"{self.busy_s()!r} s; records by stream {streams}; "
                f"annotations left out {self.annotations}")

    def top_device_ops(self, k: int = 10) -> list[list]:
        """The ``k`` device operations with the most busy time, by name.
        Kernels on several streams overlap, so each stretch of busy time
        is split evenly among the operations running in it: the names'
        times sum to :meth:`busy_s`."""
        edges = sorted([(s, 1, i) for i, (_, s, e, _) in
                        enumerate(self.device) if e > s]
                       + [(e, 0, i) for i, (_, s, e, _) in
                          enumerate(self.device) if e > s])
        share = [0.0] * len(self.device)
        active: set[int] = set()
        last = 0.0
        for t, starts, i in edges:
            if active and t > last:
                part = (t - last) / len(active)
                for j in active:
                    share[j] += part
            last = t
            if starts:
                active.add(i)
            else:
                active.discard(i)
        tot: dict[str, float] = {}
        for (name, *_), v in zip(self.device, share):
            key = short(name)
            tot[key] = tot.get(key, 0.0) + v
        return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])
                [:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The ``k`` longest stretches with no device activity, each named
        by the innermost host op running when it began."""
        merged = _merged((r[1], r[2]) for r in self.device)
        gaps = [(b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])]
        starts = [s for _, s, _ in self.host]
        out = []
        for length, start in sorted(gaps, reverse=True)[:k]:
            # the latest-starting host op still running when the gap began
            name = "no_host_op"
            for i in range(bisect.bisect_right(starts, start) - 1, -1, -1):
                if self.host[i][2] >= start:
                    name = short(self.host[i][0])
                    break
            out.append([name, length])
        return out


def short(name: str, n: int = 64) -> str:
    """A kernel or op name cut to ``n`` characters of [A-Za-z0-9_:.]."""
    return re.sub(r"[^A-Za-z0-9_:.]", "_", name)[:n]


def _merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _annotation(e) -> bool:
    """Whether a CUDA-typed event is an annotation, not device work."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() not in ("kernel", "gpu_memcpy", "gpu_memset")
    user = getattr(e, "is_user_annotation", None)
    return bool(user()) if user is not None else False


def _python(e) -> bool:
    """Whether a host event is a Python function's (not an op's)."""
    fn = getattr(e, "is_python_function", None)
    return bool(fn()) if fn is not None else False


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def traced(work: Callable[[], int], device: torch.device) -> Trace:
    """Run ``work`` (which returns the steps it ran) under the profiler and
    reduce its events."""
    from torch import profiler

    acts = [profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(profiler.ProfilerActivity.CUDA)
    with profiler.profile(activities=acts) as prof:
        sync(device)
        with profiler.record_function(WINDOW):
            steps = work()
            sync(device)
    events = prof.profiler.kineto_results.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name() == WINDOW and e.device_type() == cpu]
    if not win:
        raise RuntimeError("the profile holds no window span")
    t0 = win[0].start_ns()
    t1 = t0 + win[0].duration_ns()
    dev, host, notes = [], [], 0
    for e in events:
        s, d, name = e.start_ns(), e.duration_ns(), e.name()
        if s + d < t0 or s > t1 or name == WINDOW:
            continue
        if e.device_type() == cuda:
            if _annotation(e):
                notes += 1
                continue
            dev.append((name, max(s, t0) * 1e-9, min(s + d, t1) * 1e-9,
                        int(e.device_resource_id())))
        elif e.device_type() == cpu and not _python(e):
            host.append((name, s * 1e-9, (s + d) * 1e-9))
    dev.sort(key=lambda t: t[1])
    host.sort(key=lambda t: t[1])
    return Trace(window_s=(t1 - t0) * 1e-9, device=dev, host=host,
                 steps=steps, annotations=notes)
