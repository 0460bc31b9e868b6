"""The port's ``event_driven`` engine against the reference's.

A seeded run (6 clients, 2 coalitions, 1 local epoch, shard regime, 600
training samples, as ``tests/test_torch_federation.py``) on the reference's
``cellular-flaky`` table (``carry.fleet_from_jax``) with its draws injected:
the shuffles of each event's key, the Step-I permutation and the
availability draws of the ``AVAILABILITY_STREAM`` fork, one ``sample_mask``
step per event.  The budget of 60 J retires three devices at the census
(their cycle costs 46-214 J) and one more at the fifth event, so the ledger
is exercised on both sides.  The fire sets (read off the ledger), the
participation, the retirement flags and the assignments must be equal;
the event times, energy ledger, per-event seconds and bytes within rtol
1e-6 (f32 sums of the same terms), and so the coalition masses, whose
staleness weights ``(1 + age_s)^-0.5`` come from XLA's and ATen's f32
``pow`` and may differ by an ulp (the census row's whole-number masses are
equal); θ within 1e-4 of max|θ| and the accuracy within 2/n_test, the
federation tests' bounds.

Port-only corner cases: a budget below every cycle's cost retires the whole
fleet at the census, so every event fires nothing, the clock stays frozen
and every row is finite with zero participation; and on the ``ideal`` fleet
with an unbounded budget the engine equals ``scan`` bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch import sim as tsim
from repro_torch.core.client import ClientConfig
from repro_torch.core.server import Federation, FederationConfig
from repro_torch.models import zoo
from test_torch_federation import (EPOCHS, K, N_CLIENTS, N_TEST, ROUNDS,
                                   _assert_theta_close, _data, _run_both)
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

BUDGET = 60.0
EVENTS = 5
RTOL = 1e-6


def _fires(spent: np.ndarray) -> np.ndarray:
    """(R - 1, N) fire sets: the devices the ledger charged at each event."""
    return np.diff(spent, axis=0) > 0


def test_event_driven_matches_reference():
    (theta, hist), (theta_ref, jhist) = _run_both(
        "coalition", "event_driven", "cellular-flaky",
        sim_kw={"energy_budget": BUDGET, "max_events": EVENTS},
        rows=EVENTS + 1)
    t, jt = hist.trace, jhist.trace
    assert t.event_time.shape == (EVENTS + 1,)
    spent, jspent = t.energy_spent, np.asarray(jt.energy_spent)
    fires = _fires(spent)
    np.testing.assert_array_equal(fires, _fires(jspent))
    assert fires.any(axis=1).all()          # every event fired someone
    np.testing.assert_array_equal(t.participation,
                                  np.asarray(jt.participation))
    exhausted = t.energy_exhausted
    np.testing.assert_array_equal(exhausted, np.asarray(jt.energy_exhausted))
    # a device retires at the census and another during the events
    assert 0 < exhausted[0].sum() < exhausted[-1].sum() < N_CLIENTS
    assert hist.assignments == jhist.assignments
    np.testing.assert_array_equal(t.counts[0], np.asarray(jt.counts)[0])
    for got, want in ((t.counts, jt.counts),
                      (t.event_time, jt.event_time), (spent, jspent),
                      (t.sim_time, jt.sim_time),
                      (t.wan_bytes, jt.wan_bytes),
                      (t.edge_bytes, jt.edge_bytes)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=0)
    assert np.all(np.diff(t.event_time) >= 0)
    assert np.all(spent <= BUDGET)
    np.testing.assert_allclose(hist.test_acc, jhist.test_acc, rtol=0,
                               atol=2.0 / N_TEST)
    _assert_theta_close(theta, theta_ref)


def _port_run(engine, fleet="ideal", method="coalition", **sim_kw):
    data, (xte, yte) = _data()
    model = zoo.make_model("cnn")
    xte_t, yte_t = torch.from_numpy(xte), torch.from_numpy(yte)
    gen = torch.Generator().manual_seed(5)
    params = model.init(gen)
    cfg = FederationConfig(n_clients=N_CLIENTS, n_coalitions=K,
                           rounds=ROUNDS, method=method, engine=engine,
                           client=ClientConfig(epochs=EPOCHS),
                           sim=tsim.SimConfig(fleet=fleet, **sim_kw))
    return Federation(model, lambda p: model.accuracy(p, xte_t, yte_t),
                      cfg).run(params, {k: torch.from_numpy(v)
                                        for k, v in data.items()},
                               generator=gen)


def test_all_retired_fleet_freezes_the_clock_without_nan():
    gp, hist = _port_run("event_driven", "cellular-flaky",
                         energy_budget=1e-3, max_events=3)
    t = hist.trace
    assert t.energy_exhausted.all()               # retired at the census
    assert not t.participation[1:].any()
    assert np.all(t.event_time == t.event_time[0])
    np.testing.assert_array_equal(t.sim_time[1:], 0.0)
    np.testing.assert_array_equal(t.energy_spent,
                                  np.full_like(t.energy_spent, 1e-3))
    for name in t._fields:
        value = getattr(t, name)
        if value is not None:
            assert np.all(np.isfinite(value)), name
    assert all(torch.isfinite(v).all() for v in gp.values())


@pytest.mark.parametrize("method", ["coalition", "fedavg"])
def test_event_driven_on_ideal_equals_scan_bit_for_bit(method):
    """Ideal fleet, unbounded budget: every event fires the whole fleet at
    t = 0 and the run is ``scan``'s, θ and every shared field bit for bit."""
    gp_s, hist_s = _port_run("scan", method=method)
    gp_e, hist_e = _port_run("event_driven", method=method)
    for name in gp_s:
        assert torch.equal(gp_s[name], gp_e[name]), name
    for field in ("loss", "acc", "assignment", "counts", "churn", "entropy",
                  "radius", "drift"):
        np.testing.assert_array_equal(getattr(hist_e.trace, field),
                                      getattr(hist_s.trace, field),
                                      err_msg=field)
    assert np.all(hist_e.trace.participation == 1.0)
    assert hist_e.event_times == [0.0] * ROUNDS
    assert not np.any(hist_e.trace.energy_exhausted)
