"""The port's run ledger and timeline against the reference's.

- ``coerce`` turns tensors of any dtype (bf16 included) into JSON values
  through ``.tolist()`` / ``.item()``, NaN into null; the sink registry,
  the JSONL sink and ``tee`` behave as the reference's.
- A port-written ledger (``Federation.run(sink=...)``) has the reference's
  record kinds and, kind by kind, its keys for the same configuration, on
  ``scan``, ``semi_async`` and ``event_driven`` and under an attack with
  the DP path; on the substrate engines
  the reference's ``validate_trace(build_trace(read_ledger(...)))``
  accepts it with no errors, and the port's ``build_trace`` gives the
  reference's trace for the same records.
- Streaming leaves the run bit for bit as it was; ``metrics_every`` keeps
  rounds 0, k, 2k, ... and the final one.
- The train CLI's ``--metrics-out``, ``--trace-out``, ``--profile-dir``
  and ``--out``.

Least squares on 12 features (the reference's tests/test_obs.py problem),
so each run takes well under a second.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import sim as jsim
from repro.core.client import ClientConfig as JClientConfig
from repro.core.server import Federation as JFederation
from repro.core.server import FederationConfig as JFederationConfig
from repro.obs import timeline as jtimeline
from repro_torch import obs
from repro_torch import sim as tsim
from repro_torch.core.client import ClientConfig
from repro_torch.core.server import (TIMING_FIELDS, Federation,
                                     FederationConfig)
from repro_torch.launch import train as ttrain
from repro_torch.models import zoo
from repro_torch.obs import timeline
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

N_CLIENTS, N_LOCAL, DIM = 6, 20, 12
ENGINES = ("scan", "semi_async", "event_driven")


def _problem():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N_CLIENTS, N_LOCAL, DIM)).astype(np.float32)
    w_true = rng.standard_normal(DIM).astype(np.float32)
    y = (x @ w_true + 0.1 * rng.standard_normal((N_CLIENTS, N_LOCAL))
         ).astype(np.float32)
    return x, y, w_true


def _tloss(p, batch):
    return torch.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)


LSQ = zoo.FLModel(name="lsq", init=None, loss_fn=_tloss, accuracy=None,
                  layout=(("w", "w", None),))


#: an attack and the DP path, whose blocks the run_meta record carries
ATTACK_DP = {"attack": "sign_flip", "adv_frac": 0.34}
DP = {"dp_clip": 1.0, "dp_sigma": 0.5}


def _run(engine, rounds=4, fed_kw=None, client_kw=None, **run_kw):
    x, y, w_true = _problem()
    xe = torch.from_numpy(x.reshape(-1, DIM)[:40])
    ye = xe @ torch.from_numpy(w_true)
    cfg = FederationConfig(
        n_clients=N_CLIENTS, n_coalitions=2, rounds=rounds,
        method="coalition", engine=engine,
        client=ClientConfig(epochs=1, batch_size=10, lr=0.05,
                            **(client_kw or {})),
        sim=tsim.SimConfig(fleet="cellular-flaky", seed=3), **(fed_kw or {}))
    return Federation(LSQ, lambda p: -torch.mean((xe @ p["w"] - ye) ** 2),
                      cfg).run({"w": torch.zeros(DIM)},
                               {"x": torch.from_numpy(x),
                                "y": torch.from_numpy(y)},
                               generator=torch.Generator().manual_seed(7),
                               **run_kw)


def _reference_records(engine, rounds=4, fed_kw=None, client_kw=None):
    x, y, w_true = _problem()

    def loss_fn(params, batch):
        return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    xe = jnp.asarray(x.reshape(-1, DIM)[:40])
    ye = xe @ jnp.asarray(w_true)
    cfg = JFederationConfig(
        n_clients=N_CLIENTS, n_coalitions=2, rounds=rounds,
        method="coalition", engine=engine,
        client=JClientConfig(epochs=1, batch_size=10, lr=0.05,
                             **(client_kw or {})),
        sim=jsim.SimConfig(fleet="cellular-flaky", seed=3), **(fed_kw or {}))
    mem = jobs.InMemorySink()
    JFederation(loss_fn, lambda p: -jnp.mean((xe @ p["w"] - ye) ** 2),
                cfg).run({"w": jnp.zeros((DIM,))},
                         {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                         jax.random.key(7), sink=mem)
    return mem.records


def _records(engine, rounds=4, fed_kw=None, client_kw=None):
    mem = obs.InMemorySink()
    _run(engine, rounds, fed_kw, client_kw, sink=mem)
    return mem.records


class TestLedger:
    def test_coerce_tensors(self):
        rec = obs.coerce({"a": torch.tensor([1.0, float("nan")]),
                          "b": torch.tensor(3, dtype=torch.int32),
                          "c": torch.tensor([[0.5]], dtype=torch.bfloat16),
                          "d": (np.float32(2.0), [torch.tensor(True)]),
                          "e": float("inf")})
        assert rec == {"a": [1.0, None], "b": 3, "c": [[0.5]],
                       "d": [2.0, [True]], "e": None}
        json.dumps(rec)

    def test_schema_and_kinds_are_the_reference_s(self):
        assert (obs.OBS_SCHEMA, obs.RUN_META, obs.ROUND, obs.SERVE_BATCH) \
            == (jobs.OBS_SCHEMA, jobs.RUN_META, jobs.ROUND,
                jobs.SERVE_BATCH)

    def test_registry(self):
        assert obs.available_sinks() == jobs.available_sinks()
        with pytest.raises(KeyError, match="unknown sink"):
            obs.make_sink("no-such-sink")

        @obs.register_sink("_test_sink")
        def _make(**_):
            return obs.InMemorySink()

        try:
            assert isinstance(obs.make_sink("_test_sink"), obs.InMemorySink)
        finally:
            del obs.ledger._SINKS["_test_sink"]

    def test_jsonl_roundtrip_and_close(self, tmp_path):
        path = str(tmp_path / "run.jsonl")
        sink = obs.make_sink("jsonl", path=path)
        sink.emit({"kind": "round", "round": 0,
                   "radius": torch.tensor([1.0, float("nan")])})
        sink.close()
        sink.close()                            # idempotent
        [rec] = [json.loads(ln) for ln in open(path)]
        assert rec["round"] == 0 and rec["radius"] == [1.0, None]
        with pytest.raises(RuntimeError, match="closed"):
            sink.emit({"kind": "round"})

    def test_tee(self):
        a, b = obs.InMemorySink(), obs.InMemorySink()
        assert obs.tee([]) is None
        assert obs.tee([a]) is a
        obs.tee([a, b]).emit({"kind": "round", "round": 1})
        assert a.records == b.records == [{"kind": "round", "round": 1}]


@pytest.mark.parametrize("engine,fed_kw,client_kw",
                         [(e, None, None) for e in ENGINES]
                         + [("scan", ATTACK_DP, DP)])
def test_records_match_the_reference_s_kinds_and_keys(engine, fed_kw,
                                                      client_kw):
    got = _records(engine, fed_kw=fed_kw, client_kw=client_kw)
    want = _reference_records(engine, fed_kw=fed_kw, client_kw=client_kw)
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w), (g["kind"], set(g) ^ set(w))
    assert [r["round"] for r in got[1:]] == list(range(4))
    meta, jmeta = got[0], want[0]
    for key in ("schema", "engine", "method", "n_clients", "n_groups",
                "steps", "attack", "adv_frac", "dp_clip", "dp_epsilon"):
        assert meta.get(key) == jmeta.get(key), key
    if engine != "scan":
        assert meta["model_bytes"] == jmeta["model_bytes"]
        assert len(meta["device_time_s"]) == N_CLIENTS


@pytest.mark.parametrize("engine", ["semi_async", "event_driven"])
def test_reference_timeline_accepts_the_port_s_ledger(engine, tmp_path):
    path = str(tmp_path / "run.jsonl")
    with obs.make_sink("jsonl", path=path) as sink:
        _run(engine, sink=sink)
    records = jtimeline.read_ledger(path)
    trace = jtimeline.build_trace(records)
    assert jtimeline.validate_trace(trace) == []
    assert timeline.build_trace(timeline.read_ledger(path)) == trace
    pids = {e["pid"] for e in trace["traceEvents"] if e["ph"] == "B"}
    assert {timeline.PID_DEVICES, timeline.PID_COALITIONS} <= pids


def test_rounds_only_engine_is_rejected():
    with pytest.raises(ValueError, match="sim_time"):
        timeline.build_trace(_records("scan"))


def test_validator_catches_corruption():
    bad = {"traceEvents": [
        {"ph": "E", "ts": 0.0, "pid": 0, "tid": 0, "name": "x"},
        {"ph": "B", "ts": 1.0, "pid": 0, "tid": 0, "name": "x"}]}
    assert timeline.validate_trace(bad) == jtimeline.validate_trace(bad)
    assert timeline.validate_trace(bad)
    unsorted = {"traceEvents": [
        {"ph": "C", "ts": 5.0, "pid": 2, "tid": 0, "name": "c", "args": {}},
        {"ph": "C", "ts": 1.0, "pid": 2, "tid": 0, "name": "c", "args": {}}]}
    assert any("sorted" in p for p in timeline.validate_trace(unsorted))


@pytest.mark.parametrize("engine", ENGINES)
def test_sink_leaves_run_bit_identical(engine):
    gp0, h0 = _run(engine)
    gp1, h1 = _run(engine, sink=obs.InMemorySink())
    assert torch.equal(gp0["w"], gp1["w"])
    for f in h0.trace._fields:
        a, b = getattr(h0.trace, f), getattr(h1.trace, f)
        if a is not None and f not in TIMING_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_metrics_every_cadence():
    mem = obs.InMemorySink()
    _run("scan", rounds=6, metrics_every=2, sink=mem)
    assert [r["round"] for r in mem.records if r["kind"] == obs.ROUND] \
        == [0, 2, 4, 5]
    assert mem.records[0]["kind"] == obs.RUN_META


def test_cli_ledger_trace_profile_and_out(tmp_path, capsys):
    paths = {k: str(tmp_path / f"{k}.json") for k in ("m", "t", "o")}
    out = ttrain.main([
        "--mode", "fl", "--device", "cpu", "--rounds", "2", "--clients", "4",
        "--coalitions", "2", "--local-epochs", "1", "--n-train", "200",
        "--n-test", "50", "--engine", "semi_async", "--fleet",
        "cellular-flaky", "--metrics-out", paths["m"], "--trace-out",
        paths["t"], "--profile-dir", str(tmp_path / "prof"), "--out",
        paths["o"]])
    capsys.readouterr()
    records = jtimeline.read_ledger(paths["m"])
    assert [r["kind"] for r in records] == ["run_meta", "round", "round"]
    trace = json.load(open(paths["t"]))
    assert jtimeline.validate_trace(trace) == []
    assert out["trace_events"] == len(trace["traceEvents"])
    written = json.load(open(paths["o"]))
    assert written["metrics_out"] == paths["m"]
    assert written["profile_dir"] == str(tmp_path / "prof")
    assert json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]
    with pytest.raises(SystemExit, match="metrics-every"):
        ttrain.main(["--mode", "fl", "--device", "cpu", "--clients", "4",
                     "--n-train", "100", "--n-test", "20",
                     "--metrics-every", "2"])
