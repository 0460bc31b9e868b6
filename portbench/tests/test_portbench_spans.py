"""The readers of the FL round's phases (``harness/phases.py`` and the
seven metrics on the ``fl.*`` spans) on a hand-built trace with exact
values, and on the ``fl`` driver's traced window on the CPU; and the mode
order of ``scripts/profiler_cost.py``."""
from __future__ import annotations

import math
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench.harness import phases, profile, spec  # noqa: E402

SPAN_METRICS = ("shuffle_ms.fl", "readback_ms.fl", "eval_ms.fl",
                "idle_local_ms.fl", "idle_server_ms.fl", "idle_loop_ms.fl",
                "local_launches.fl")
IDLE = ("idle_local_ms.fl", "idle_server_ms.fl", "idle_loop_ms.fl")


def _read(name: str, tr) -> float | None:
    return spec.load_module("metrics", name).read({"trace": tr})


FL_SPANS = ("fl.shuffle", "fl.server", "fl.eval", "fl.readback")


def _round(t0: float) -> list[tuple[str, float, float]]:
    """One round's four spans from ``t0``: shuffle 0.5 s, then the local
    phase's 2.5 s unmarked, server 0.5 s, eval 0.25 s, read-back 0.25 s."""
    edges = [(0.0, 0.5), (3.0, 3.5), (3.5, 3.75), (3.75, 4.0)]
    return [(n, t0 + a, t0 + b) for n, (a, b) in zip(FL_SPANS, edges)]


#: two rounds in an 8 s window; every time a sum of powers of two, so the
#: readings below are exact
DEVICE = [("k1", 0.25, 0.75, 7),          # shuffle 0.25 s, local 0.25 s
          ("k2", 1.0, 2.0, 7),            # local, overlapping k3 on another
          ("k3", 1.5, 2.5, 8),            # stream: [1.0, 2.5] busy
          ("k4", 3.25, 3.5, 7),           # server 0.25 s
          ("k5", 3.5, 3.625, 7),          # eval
          ("Memcpy DtoH (Device -> Pinned)", 3.875, 4.0, 7),  # read-back
          ("k6", 4.5, 7.0, 7),            # round 2's local phase, all busy
          ("k7", 7.5, 8.0, 7)]            # round 2's eval and read-back
LAUNCHES = [("cudaLaunchKernelExC", 0.1, 0.11),   # in fl.shuffle
            ("cudaLaunchKernel", 1.0, 1.01),      # in the local phase
            ("cudaMemcpyAsync", 1.2, 1.3),        # not a launch
            ("cuLaunchKernel", 2.9, 2.91),        # in the local phase
            ("cudaLaunchKernel", 3.25, 3.26),     # in fl.server
            ("cuLaunchKernelEx", 4.6, 4.61),      # in the local phase
            ("cudaLaunchKernel", 7.6, 7.61)]      # in fl.eval


def _trace(host=None) -> profile.Trace:
    host = _round(0.0) + _round(4.0) + LAUNCHES if host is None else host
    return profile.Trace(window_s=8.0, device=sorted(DEVICE,
                                                     key=lambda r: r[1]),
                         host=sorted(host, key=lambda h: h[1]), steps=2)


def test_overlap_of_interval_lists():
    a = [(0.0, 1.0), (2.0, 3.0), (5.0, 6.0)]
    b = [(0.5, 2.5), (2.75, 5.5)]
    assert phases.overlap(a, b) == 0.5 + 0.5 + 0.25 + 0.5
    assert phases.overlap(a, []) == 0.0
    assert phases.overlap(b, a) == phases.overlap(a, b)


@pytest.mark.parametrize("name,want", [
    ("shuffle_ms.fl", 500.0),       # (0.5 + 0.5) s / 2 rounds
    ("readback_ms.fl", 250.0),      # (0.25 + 0.25) / 2
    ("eval_ms.fl", 375.0),          # busy (0.125 + 0.125 + 0.5) / 2
    ("idle_local_ms.fl", 375.0),    # (2.5 - 1.75 + 0) / 2
    ("idle_server_ms.fl", 375.0),   # (0.25 + 0.5) / 2
    ("idle_loop_ms.fl", 500.0),     # (0.25 + 0.75 + 0) / 2
    ("local_launches.fl", 1.5)])    # 3 launches in the local phase / 2
def test_reader_on_a_hand_built_trace(name, want):
    assert _read(name, _trace()) == want


def test_idle_metrics_partition_the_window():
    tr = _trace()
    assert tr.busy_s() == 5.5
    total = sum(_read(m, tr) for m in IDLE)
    idle_share = spec.load_module("metrics", "device_idle.fl").read(
        {"trace": tr})
    assert total == 1e3 * (tr.window_s - tr.busy_s()) / tr.steps
    assert math.isclose(total, idle_share / 100 * tr.window_s / tr.steps
                        * 1e3, rel_tol=1e-12)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_reads_nothing_without_the_spans(name):
    # the parent program's trace: the same device work and launches, no
    # span; and no trace at all (an untraced run)
    assert _read(name, _trace(host=list(LAUNCHES))) is None
    assert _read(name, None) is None


def test_eval_needs_both_of_its_spans():
    host = [h for h in _round(0.0) if h[0] != "fl.readback"]
    assert _read("eval_ms.fl", _trace(host=host)) is None
    assert _read("shuffle_ms.fl", _trace(host=host)) == 250.0


def test_local_phase_is_the_gap_from_shuffle_to_server():
    assert phases.local_phase(_trace()) == [(0.5, 3.0), (4.5, 7.0)]
    # a round whose server span is missing pairs no local phase, and the
    # local readers then read nothing
    host = _round(0.0) + [h for h in _round(4.0) if h[0] != "fl.server"]
    tr = _trace(host=host + LAUNCHES)
    assert phases.local_phase(tr) == []
    for name in ("idle_local_ms.fl", "idle_loop_ms.fl", "local_launches.fl"):
        assert _read(name, tr) is None


def test_launches_count_only_inside_the_local_phase():
    outside = [h for h in LAUNCHES if not 0.5 <= h[1] <= 3.0
               and not 4.5 <= h[1] <= 7.0]
    tr = _trace(host=_round(0.0) + _round(4.0) + outside)
    assert _read("local_launches.fl", tr) == 0.0


@pytest.fixture(scope="module")
def fl_traced():
    """The ``fl`` driver's ``--trace 1`` run at a tiny size on the CPU."""
    from test_portbench_drivers import FL_SIZES

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell = spec.cell("fl_cnn_cohort100")
        driver = spec.load_module("drivers", cell.driver)
        out = driver.run(cell, seed=2 ** 35 + 11, seconds=0.5, trace=True,
                         device=torch.device("cpu"),
                         t_start=time.perf_counter(), sizes=FL_SIZES)
    finally:
        torch.set_num_threads(n)
    return cell, out


def test_fl_driver_trace_reads_every_span_metric(fl_traced):
    cell, out = fl_traced
    names = {m["name"] for m in cell.per_layer}
    assert set(SPAN_METRICS) <= names
    tr = out.ctx["trace"]
    marked = [h[0] for h in tr.host if h[0].startswith("fl.")]
    assert marked == list(FL_SPANS) * tr.steps
    values = {m: _read(m, tr) for m in SPAN_METRICS}
    for m, v in values.items():
        assert v is not None and math.isfinite(v) and v >= 0, (m, v)
    assert values["shuffle_ms.fl"] > 0 and values["readback_ms.fl"] > 0
    # no device here: no launches, no busy time, the window all idle
    assert values["local_launches.fl"] == 0 and values["eval_ms.fl"] == 0
    assert math.isclose(sum(values[m] for m in IDLE),
                        1e3 * tr.window_s / tr.steps, rel_tol=1e-9)


def test_profiler_cost_mode_order(monkeypatch):
    """``scripts/profiler_cost.py`` at a tiny size on the CPU: the modes in
    turn, one line a run and a summary, and ``bare`` runs open no range."""
    import importlib.util
    import io
    import json

    from repro_torch.core import server
    from test_portbench_drivers import FL_SIZES

    path = ROOT / "scripts" / "profiler_cost.py"
    mod_spec = importlib.util.spec_from_file_location("profiler_cost", path)
    profiler_cost = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(profiler_cost)
    opened = []
    real = server.record_function

    def counted(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(server, "record_function", counted)
    buf = io.StringIO()
    summary = profiler_cost.measure(
        spec.cell("fl_cnn_cohort100"), 2 ** 33 + 5, torch.device("cpu"),
        reps=2, rounds=3, sizes=FL_SIZES, out=buf)
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert [x["mode"] for x in lines[:-1]] == ["off", "spans", "bare",
                                              "bare", "spans", "off"]
    assert lines[-1]["summary"] == summary
    # four ranges a round in the warm run (2 rounds) and in the two off and
    # two spans runs (3 rounds each); none in the bare runs
    assert len(opened) == 4 * (2 + 4 * 3)
