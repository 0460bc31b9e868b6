"""Simulated-time timeline export — the run ledger as Chrome trace-event
JSON, loadable in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

The substrate engines simulate a fleet in continuous time (per-device
download+compute+upload cycles, round barriers or completion events, energy
depletion) — a timeline is the natural way to *see* that: one track per
device showing when it was busy with a train-and-report cycle, one track
per coalition showing the partition interval-by-interval (span name = the
coalition's mass, args carry its intra radius and barycenter drift), and
counter tracks for churn / size entropy / WAN / edge bytes / participant
count.

Input is the streaming run ledger (:mod:`repro_torch.obs.ledger` records — a
``run_meta`` header plus one ``round`` record per round or completion
event), so the export works from a live run's ``--metrics-out`` JSONL file
or from an :class:`~repro_torch.obs.ledger.InMemorySink` without
re-running anything.  Timestamps are simulated seconds converted to
trace-event microseconds; real-hardware time is the separate
``--profile-dir`` (``torch.profiler``) path of ``train.py``.  The port's
copy of ``repro.obs.timeline``: the same trace from the same records.

CLI::

    PYTHONPATH=src python -m repro_torch.obs.timeline run.jsonl -o trace.json

Every emitted trace is validated (:func:`validate_trace`: required keys,
globally sorted timestamps, per-track matched B/E pairs) — the same checks
CI runs against the exported artifact.
"""
from __future__ import annotations

import argparse
import json
from typing import Any

from repro_torch.obs import ledger as lg

#: trace-event process ids (one "process" per conceptual track group)
PID_DEVICES = 0
PID_COALITIONS = 1
PID_TELEMETRY = 2

_US = 1e6    # simulated seconds -> trace-event microseconds


def _meta_event(pid: int, name: str, what: str = "process_name",
                tid: int = 0) -> dict:
    return {"ph": "M", "pid": pid, "tid": tid, "ts": 0, "name": what,
            "args": {"name": name}}


def _intervals(rounds: list[dict], engine: str) -> list[tuple[float, float]]:
    """Per-round ``(start_s, end_s)`` simulated-time intervals.

    ``event_driven`` records carry the absolute event timestamp directly;
    the round-synchronous substrate engine only records per-round durations,
    so intervals are the cumulative sum.
    """
    out, clock = [], 0.0
    for rec in rounds:
        dur = rec.get("sim_time")
        if dur is None:
            raise ValueError(
                f"round {rec.get('round')} has no sim_time — the timeline "
                f"needs a substrate engine run (engine={engine!r}; use "
                "--engine semi_async or event_driven)")
        dur = max(float(dur), 0.0)
        if engine == "event_driven" and rec.get("event_time") is not None:
            end = float(rec["event_time"])
            out.append((max(end - dur, 0.0), end))
            clock = end
        else:
            out.append((clock, clock + dur))
            clock += dur
    return out


def build_trace(records: list[dict]) -> dict:
    """Ledger records -> a Chrome trace-event JSON object.

    Events are generated track-by-track in causal order, then stable-sorted
    by timestamp — so the global list has non-decreasing ``ts`` while every
    (pid, tid) track keeps its B/E pairs properly ordered even across
    zero-length spans (frozen-clock events, the ideal fleet).
    """
    meta = next((r for r in records if r.get("kind") == lg.RUN_META), {})
    rounds = sorted((r for r in records if r.get("kind") == lg.ROUND),
                    key=lambda r: r.get("round", 0))
    if not rounds:
        raise ValueError("no 'round' records in the ledger")
    engine = meta.get("engine", "semi_async")
    first = rounds[0]
    n = int(meta.get("n_clients") or len(first.get("assignment", [])))
    k = int(meta.get("n_groups") or len(first.get("counts", [])))
    dev_time = meta.get("device_time_s")
    spans = _intervals(rounds, engine)

    events: list[dict] = [
        _meta_event(PID_DEVICES, "fleet devices"),
        _meta_event(PID_COALITIONS, "coalitions"),
        _meta_event(PID_TELEMETRY, "run telemetry"),
    ]
    for i in range(n):
        events.append(_meta_event(PID_DEVICES, f"device {i}",
                                  "thread_name", tid=i))
    for j in range(k):
        events.append(_meta_event(PID_COALITIONS, f"coalition {j}",
                                  "thread_name", tid=j))

    for rec, (start, end) in zip(rounds, spans):
        r = rec.get("round")
        dur = end - start
        # one busy span per participating device
        part = rec.get("participation") or [1.0] * n
        energy = rec.get("energy_spent")
        for i in range(n):
            if not part[i]:
                continue
            busy = dur if dev_time is None else min(float(dev_time[i]), dur)
            args: dict[str, Any] = {"round": r}
            if energy is not None:
                args["energy_spent_j"] = energy[i]
            events.append({"ph": "B", "pid": PID_DEVICES, "tid": i,
                           "ts": max(end - busy, start) * _US
                           if engine == "event_driven" else start * _US,
                           "name": f"r{r}", "cat": "cycle", "args": args})
            events.append({"ph": "E", "pid": PID_DEVICES, "tid": i,
                           "ts": end * _US if engine == "event_driven"
                           else (start + busy) * _US})
        # one partition span per coalition
        counts = rec.get("counts") or []
        radius = rec.get("radius") or [None] * k
        drift = rec.get("drift") or [None] * k
        for j in range(min(k, len(counts))):
            events.append({"ph": "B", "pid": PID_COALITIONS, "tid": j,
                           "ts": start * _US, "cat": "partition",
                           "name": f"size={counts[j]:g}",
                           "args": {"round": r, "size": counts[j],
                                    "intra_radius": radius[j],
                                    "bary_drift": drift[j]}})
            events.append({"ph": "E", "pid": PID_COALITIONS, "tid": j,
                           "ts": end * _US})
        # run-level counters at the round's close
        for name in ("churn", "entropy", "wan_bytes", "edge_bytes",
                     "loss", "acc"):
            if rec.get(name) is not None:
                events.append({"ph": "C", "pid": PID_TELEMETRY, "tid": 0,
                               "ts": end * _US, "name": name,
                               "args": {name: rec[name]}})
        if rec.get("participation") is not None:
            events.append({"ph": "C", "pid": PID_TELEMETRY, "tid": 0,
                           "ts": end * _US, "name": "participants",
                           "args": {"participants": sum(part)}})

    events.sort(key=lambda e: e["ts"])        # stable: per-track order kept
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": lg.OBS_SCHEMA, "engine": engine,
                          "method": meta.get("method"),
                          "n_clients": n, "n_groups": k}}


def validate_trace(trace: dict) -> list[str]:
    """Schema checks CI gates the exported artifact on.  Returns errors.

    1. ``traceEvents`` is a list of events that each carry ``ph``/``ts``/
       ``pid`` with a known phase.
    2. Timestamps are globally non-decreasing.
    3. Every (pid, tid) track's duration events are matched B/E pairs —
       never an unopened E, never a span left open.
    """
    errors: list[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    last_ts = None
    depth: dict[tuple, int] = {}
    for i, e in enumerate(events):
        ph, ts = e.get("ph"), e.get("ts")
        if ph not in ("B", "E", "X", "C", "M"):
            errors.append(f"event {i}: unknown phase {ph!r}")
            continue
        if not isinstance(ts, (int, float)) or "pid" not in e:
            errors.append(f"event {i}: missing ts/pid")
            continue
        if last_ts is not None and ts < last_ts:
            errors.append(f"event {i}: ts {ts} < previous {last_ts} "
                          "(not sorted)")
        last_ts = ts
        key = (e["pid"], e.get("tid", 0))
        if ph == "B":
            depth[key] = depth.get(key, 0) + 1
        elif ph == "E":
            depth[key] = depth.get(key, 0) - 1
            if depth[key] < 0:
                errors.append(f"event {i}: E without matching B on "
                              f"track {key}")
                depth[key] = 0
    for key, d in depth.items():
        if d != 0:
            errors.append(f"track {key}: {d} unclosed B span(s)")
    return errors


def write_trace(path: str, records: list[dict]) -> dict:
    """Build, validate, and write a trace file; returns the trace object."""
    trace = build_trace(records)
    errors = validate_trace(trace)
    if errors:
        raise ValueError("invalid trace: " + "; ".join(errors))
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def read_ledger(path: str) -> list[dict]:
    """Load a JSONL run ledger (``train.py --metrics-out``)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ledger",
                    help="run ledger JSONL (train.py --metrics-out PATH)")
    ap.add_argument("-o", "--out", default="trace.json",
                    help="trace-event JSON output (open in "
                         "https://ui.perfetto.dev)")
    return ap


def main() -> None:
    args = build_parser().parse_args()
    trace = write_trace(args.out, read_ledger(args.ledger))
    ev = trace["traceEvents"]
    print(json.dumps({
        "out": args.out, "events": len(ev),
        "engine": trace["otherData"]["engine"],
        "devices": trace["otherData"]["n_clients"],
        "coalitions": trace["otherData"]["n_groups"],
        "span_us": ev[-1]["ts"] - ev[0]["ts"] if ev else 0.0}))


if __name__ == "__main__":
    main()
