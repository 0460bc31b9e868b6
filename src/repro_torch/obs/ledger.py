"""Streaming run ledger — structured per-round telemetry records and the
sink registry that receives them (the port's copy of ``repro.obs.ledger``,
same record schema).

A *sink* is where live telemetry goes while a (possibly multi-hour) run is
still executing: the federation engine hands each finished round's trace
row to the sink on the host side, after the round's values were read back
anyway — so streaming has **zero effect on the numerics** (the sink only
ever reads rows that already exist).

Record contract (``schema = "obs/v1"``): every record is a flat
JSON-serialisable dict with a ``kind`` key —

  ``run_meta``     — one per run, first: engine/method/population config,
                     plus the per-device cycle seconds on the substrate
                     engines (what the timeline exporter needs).
  ``round``        — one per federation round (or completion event):
                     loss/acc, the coalition-dynamics block (churn, entropy,
                     per-coalition radius/drift), the full assignment and
                     mass vectors, and the substrate ledger
                     (sim_time/bytes/participation/energy) when present.
  ``serve_batch``  — the serving front end's counters per answered batch
                     (queries/s, swap latency, poll hit/miss, routing
                     fallback) — ``launch/serve.py`` feeds the same ledger.

Sinks are a registry, mirroring the strategy/backend/fleet registries::

    @register_sink("my-sink")
    def _make(**kw) -> Sink: ...

    sink = make_sink("jsonl", path="run.jsonl")

Built-ins: ``jsonl`` (one record per line, flushed per emit — tail it while
the run is live), ``stdout`` (same, to a stream), ``in_memory`` (a list —
what the timeline exporter and the tests consume).  :func:`tee` fans one
record out to several sinks.
"""
from __future__ import annotations

import json
import sys
from typing import Any, Callable, IO

import numpy as np
import torch

#: ledger record schema version (bump on incompatible record changes)
OBS_SCHEMA = "obs/v1"

#: record kinds
RUN_META = "run_meta"
ROUND = "round"
SERVE_BATCH = "serve_batch"


def coerce(value: Any) -> Any:
    """Tensor/NumPy values -> plain JSON-serialisable Python.

    Tensors (on any device, any dtype) and arrays become (nested) lists
    through ``.tolist()``, 0-d ones scalars through ``.item()``; non-finite
    floats become None (RFC 8259 JSON has no Infinity/NaN).  Dicts/lists
    recurse; everything else passes through.
    """
    if isinstance(value, dict):
        return {k: coerce(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [coerce(v) for v in value]
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        return coerce(t.tolist()) if t.ndim else coerce(t.item())
    if hasattr(value, "__array__") or isinstance(value, np.generic):
        a = np.asarray(value)
        if a.ndim:
            return coerce(a.tolist())
        value = a.item()
    if isinstance(value, float) and not np.isfinite(value):
        return None
    return value


class Sink:
    """Base sink: receives structured records; subclasses store/forward them.

    ``emit`` must be cheap and host-side only — it runs between the rounds
    of a live federation.  ``close`` is idempotent.
    """

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "Sink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class JsonlSink(Sink):
    """One JSON record per line, flushed per emit (tail -f friendly)."""

    def __init__(self, path: str):
        self.path = path
        self._f: IO[str] | None = open(path, "w")

    def emit(self, record: dict) -> None:
        if self._f is None:
            raise RuntimeError(f"JsonlSink({self.path!r}) is closed")
        json.dump(coerce(record), self._f)
        self._f.write("\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class StdoutSink(Sink):
    """JSONL to a stream (default ``sys.stdout``); never closes the stream."""

    def __init__(self, stream: IO[str] | None = None):
        self.stream = stream if stream is not None else sys.stdout

    def emit(self, record: dict) -> None:
        json.dump(coerce(record), self.stream)
        self.stream.write("\n")
        self.stream.flush()


class InMemorySink(Sink):
    """Collect records in a list (``.records``) — tests, timeline export."""

    def __init__(self):
        self.records: list[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(coerce(record))


class TeeSink(Sink):
    """Fan every record out to several sinks (closes them all)."""

    def __init__(self, sinks: list[Sink]):
        self.sinks = list(sinks)

    def emit(self, record: dict) -> None:
        for s in self.sinks:
            s.emit(record)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def tee(sinks: list[Sink]) -> Sink | None:
    """None / the one sink / a :class:`TeeSink` — whatever ``sinks`` needs."""
    if not sinks:
        return None
    if len(sinks) == 1:
        return sinks[0]
    return TeeSink(sinks)


# --- registry ----------------------------------------------------------------

_SINKS: dict[str, Callable[..., Sink]] = {}


def register_sink(name: str) -> Callable:
    """Decorator: register a sink factory under ``name``."""

    def deco(factory: Callable[..., Sink]) -> Callable[..., Sink]:
        _SINKS[name] = factory
        return factory

    return deco


def make_sink(name: str, **kw) -> Sink:
    """Build a registered sink (``jsonl`` | ``stdout`` | ``in_memory``)."""
    try:
        factory = _SINKS[name]
    except KeyError:
        raise KeyError(
            f"unknown sink {name!r}; available: {available_sinks()}"
        ) from None
    return factory(**kw)


def available_sinks() -> tuple[str, ...]:
    return tuple(sorted(_SINKS))


@register_sink("jsonl")
def _make_jsonl(*, path: str, **_) -> Sink:
    return JsonlSink(path)


@register_sink("stdout")
def _make_stdout(*, stream: IO[str] | None = None, **_) -> Sink:
    return StdoutSink(stream)


@register_sink("in_memory")
def _make_in_memory(**_) -> Sink:
    return InMemorySink()
