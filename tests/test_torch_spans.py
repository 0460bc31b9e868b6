"""The FL round loop's ranges on ``torch.profiler``'s clock
(:meth:`Federation.run`).

- Under the profiler each round yields the four ``fl.*`` host events once,
  in the order ``FL_SPANS`` gives, rounds in order, none overlapping
  another.
- Each round's local phase lies in the gap from its ``fl.shuffle`` end to
  its ``fl.server`` start, which is how the benchmark reads it.
- A profiled run and an unprofiled run of one seed give the same θ and
  the same trace bit for bit, host timings aside (``TIMING_FIELDS``).

Least squares on 12 features, so each run takes well under a second.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.client import ClientConfig
from repro_torch.core.server import (TIMING_FIELDS, Federation,
                                     FederationConfig)
from repro_torch.models import zoo
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

N_CLIENTS, N_LOCAL, DIM, ROUNDS = 6, 20, 12, 4
#: the ranges of one round, in the order the round opens them
FL_SPANS = ("fl.shuffle", "fl.server", "fl.eval", "fl.readback")
ENGINES = {"scan": {}, "semi_async": {"fleet": "cellular-flaky"},
           "event_driven": {"fleet": "cellular-flaky"}}


def _tloss(p, batch):
    return torch.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)


LSQ = zoo.FLModel(name="lsq", init=None, loss_fn=_tloss, accuracy=None,
                  layout=(("w", "w", None),))


def _run(engine: str, mark_local: bool = False):
    """The run; ``mark_local`` wraps ``Federation._local_phase`` in a
    ``test.local`` range, as the benchmark wraps it in its recorder."""
    from repro_torch import sim

    rng = np.random.default_rng(0)
    x = rng.standard_normal((N_CLIENTS, N_LOCAL, DIM)).astype(np.float32)
    w_true = rng.standard_normal(DIM).astype(np.float32)
    y = (x @ w_true + 0.1 * rng.standard_normal((N_CLIENTS, N_LOCAL))
         ).astype(np.float32)
    xe = torch.from_numpy(x.reshape(-1, DIM)[:40])
    ye = xe @ torch.from_numpy(w_true)
    cfg = FederationConfig(
        n_clients=N_CLIENTS, n_coalitions=2, rounds=ROUNDS,
        method="coalition", engine=engine,
        client=ClientConfig(epochs=1, batch_size=10, lr=0.05),
        sim=sim.SimConfig(**ENGINES[engine]))

    def eval_fn(p):
        return -torch.mean((xe @ p["w"] - ye) ** 2)

    data = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    fed = Federation(LSQ, eval_fn, cfg)
    if mark_local:
        inner = fed._local_phase

        def local_phase(*args):
            with torch.profiler.record_function("test.local"):
                return inner(*args)

        fed._local_phase = local_phase
    return fed.run({"w": torch.zeros(DIM)}, data,
                   generator=torch.Generator().manual_seed(7))


def _profiled(engine: str, mark_local: bool = False, prefix: str = "fl."):
    """The run under ``torch.profiler`` and its ``fl.*`` host events as
    (name, start ns, end ns), sorted by start."""
    from torch import profiler

    with profiler.profile(activities=[profiler.ProfilerActivity.CPU]) \
            as prof:
        out = _run(engine, mark_local)
    cpu = torch.autograd.DeviceType.CPU
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(prefix) and e.device_type() == cpu]
    return out, sorted(events, key=lambda t: t[1])


@pytest.mark.parametrize("engine", list(ENGINES))
def test_four_spans_a_round_in_order(engine):
    (_, hist), events = _profiled(engine)
    rounds = len(hist.trace.loss)
    assert rounds >= 3
    assert [n for n, _, _ in events] == list(FL_SPANS) * rounds
    for (_, s, e), (_, s_next, _) in zip(events, events[1:]):
        assert s <= e <= s_next
    assert events[-1][1] <= events[-1][2]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_profiled_run_is_bit_identical(engine):
    gp0, h0 = _run(engine)
    (gp1, h1), _ = _profiled(engine)
    assert torch.equal(gp0["w"], gp1["w"])
    for f in h0.trace._fields:
        a, b = getattr(h0.trace, f), getattr(h1.trace, f)
        assert (a is None) == (b is None), f
        if a is not None and f not in TIMING_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_local_phase_lies_between_shuffle_and_server(engine):
    (_, hist), events = _profiled(engine, mark_local=True, prefix="")
    marked = [ev for ev in events if ev[0].startswith(("fl.", "test."))]
    shuffles = [ev for ev in marked if ev[0] == "fl.shuffle"]
    servers = [ev for ev in marked if ev[0] == "fl.server"]
    locals_ = [ev for ev in marked if ev[0] == "test.local"]
    assert len(locals_) == len(shuffles) == len(servers) \
        == len(hist.trace.loss)
    for (_, _, shuffle_end), (_, s, e), (_, server_start, _) in zip(
            shuffles, locals_, servers):
        assert shuffle_end <= s <= e <= server_start


def test_timing_fields_are_the_host_timings():
    _, hist = _run("scan")
    assert TIMING_FIELDS == ("local_s", "server_s")
    for f in TIMING_FIELDS:
        t = getattr(hist.trace, f)
        assert t.shape == (ROUNDS,) and np.all(t >= 0)
