"""The port's federation loop and training CLI against the reference's.

A seeded run (6 clients, 2 coalitions, 3 rounds, 1 local epoch, shard
regime, 600 training samples) goes through both packages on the same data
and the same weights (the reference's CNN init, carried), with the
reference's random draws rebuilt here from its key splits and injected
into the port: the round key chain of ``Federation._round0`` /
``_step_scan`` (repro/core/server.py), one key per client
(``_local_phase``), one per epoch (repro/core/client.py), and the Step-I
permutation (repro/core/coalitions.py).  Per-round assignments and counts
must be equal, the final θ within 1e-4 of max|θ|, and the test accuracy
within 2/n_test each round.

The ``semi_async`` engine runs the same way on the ``cellular-flaky``
fleet: the reference's device table carried over (``carry.fleet_from_jax``)
and its availability draws rebuilt from the ``AVAILABILITY_STREAM`` fork of
its run key (repro/sim/availability.py) and injected.  Assignments and
participation must be equal, the simulated seconds and bytes within rtol
1e-6, the counts (staleness-weighted masses) within 1e-5.  On the ``ideal``
fleet the port's ``semi_async`` must equal its own ``scan`` bit for bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pytree as jpt
from repro.core.client import ClientConfig as JClientConfig
from repro.core.server import Federation as JFederation
from repro.core.server import FederationConfig as JFederationConfig
from repro.data import loader, synthetic
from repro.launch import train as jtrain
from repro import sim as jsim
from repro.models import cnn as jcnn
from repro.sim import scenarios
from repro_torch import carry
from repro_torch import sim as tsim
from repro_torch.core import pytree as tpt
from repro_torch.core.client import ClientConfig
from repro_torch.core.server import Draws, Federation, FederationConfig
from repro_torch.launch import train as ttrain
from repro_torch.models import zoo

ROOT = Path(__file__).resolve().parent.parent
N_CLIENTS, K, ROUNDS, EPOCHS, N_TRAIN, N_TEST = 6, 2, 3, 1, 600, 200
THETA_TOL = 1e-4


def availability_draws(key, fleet, participation: float = 1.0):
    """The reference's census and per-round availability draws for
    ``key``'s run (its ``_prologue_semi_async`` and ``sample_mask``)."""
    p = jsim.effective_p(fleet, participation)
    akey, k0 = jax.random.split(
        jax.random.fold_in(key, jsim.AVAILABILITY_STREAM))
    online = np.asarray(jax.random.bernoulli(k0, p))
    stay, fresh = [], []
    for _ in range(1, ROUNDS):
        akey, k_stay, k_fresh = jax.random.split(akey, 3)
        stay.append(np.asarray(jax.random.bernoulli(k_stay,
                                                    fleet.persistence)))
        fresh.append(np.asarray(jax.random.bernoulli(k_fresh, p)))
    return tsim.AvailabilityDraws(online=online, stay=np.stack(stay),
                                  fresh=np.stack(fresh))


def reference_draws(key, n_local: int, availability=None) -> Draws:
    """The shuffles and Step-I permutation the reference draws from ``key``
    (and the availability draws, when given)."""
    def shuffles(round_key):
        return np.stack([
            np.stack([np.asarray(jax.random.permutation(ek, n_local))
                      for ek in jax.random.split(ck, EPOCHS)])
            for ck in jax.random.split(round_key, N_CLIENTS)])

    key, k0, kc = jax.random.split(key, 3)
    rounds = [shuffles(k0)]
    center_perm = np.asarray(jax.random.permutation(kc, N_CLIENTS))
    for _ in range(1, ROUNDS):
        key, kr = jax.random.split(key)
        rounds.append(shuffles(kr))
    return Draws(shuffles=rounds, center_perm=center_perm,
                 availability=availability)


def _data():
    (xtr, ytr) = synthetic.digits(N_TRAIN, seed=0)
    (xte, yte) = synthetic.digits(N_TEST, seed=1)
    scn = scenarios.make_scenario("independent", ytr, N_CLIENTS,
                                  regime="shard", seed=0)
    return loader.client_datasets(xtr, ytr, scn.index_matrix), (xte, yte)


def _run_both(method="coalition", engine="scan", fleet="ideal"):
    """One seeded run through each package, the reference's draws (and
    fleet table) injected into the port's."""
    data, (xte, yte) = _data()
    init = jcnn.init(jax.random.key(0))
    key = jax.random.key(1)
    jsimcfg = jsim.SimConfig(fleet=fleet)
    jcfg = JFederationConfig(n_clients=N_CLIENTS, n_coalitions=K,
                             rounds=ROUNDS, method=method, engine=engine,
                             client=JClientConfig(epochs=EPOCHS),
                             sim=jsimcfg)
    xte_j, yte_j = jnp.asarray(xte), jnp.asarray(yte)
    jgp, jhist = JFederation(
        jcnn.loss_fn, lambda p: jcnn.accuracy(p, xte_j, yte_j), jcfg,
    ).run(init, jax.tree.map(jnp.asarray, data), key)

    jfleet = jsim.make_fleet(fleet, N_CLIENTS, seed=jsimcfg.seed)
    avail = availability_draws(key, jfleet) if engine == "semi_async" \
        else None
    model = zoo.make_model("cnn")
    xte_t, yte_t = torch.from_numpy(xte), torch.from_numpy(yte)
    cfg = FederationConfig(n_clients=N_CLIENTS, n_coalitions=K, rounds=ROUNDS,
                           method=method, engine=engine,
                           client=ClientConfig(epochs=EPOCHS),
                           sim=tsim.SimConfig(fleet=fleet))
    gp, hist = Federation(
        model, lambda p: model.accuracy(p, xte_t, yte_t), cfg,
        fleet=carry.fleet_from_jax(jfleet),
    ).run(carry.params_from_jax(jax.tree.map(np.asarray, init)),
          {k: torch.from_numpy(v) for k, v in data.items()},
          draws=reference_draws(key, data["y"].shape[1], avail))
    theta_ref = np.asarray(jpt.flatten(jgp))
    theta = tpt.flatten(gp, model.layout).numpy()
    return (theta, hist), (theta_ref, jhist)


def _assert_theta_close(theta, theta_ref):
    scale = np.abs(theta_ref).max()
    np.testing.assert_allclose(theta / scale, theta_ref / scale, rtol=0,
                               atol=THETA_TOL)


def test_seeded_federation_matches_reference():
    (theta, hist), (theta_ref, jhist) = _run_both()

    assert hist.assignments == jhist.assignments
    assert hist.counts == jhist.counts
    np.testing.assert_allclose(hist.test_acc, jhist.test_acc, rtol=0,
                               atol=2.0 / N_TEST)
    _assert_theta_close(theta, theta_ref)
    assert hist.churn[0] == 0.0 and len(hist.drift) == ROUNDS
    assert all(t >= 0 for t in hist.trace.local_s)
    assert hist.sim_times is None and hist.participation is None


@pytest.mark.parametrize("method", ["coalition", "fedavg"])
def test_semi_async_matches_reference(method):
    """Algorithm 1 and its FedAvg baseline on the cellular-flaky fleet,
    every draw injected: the same participation, staleness-weighted
    aggregation and byte accounting as the reference."""
    (theta, hist), (theta_ref, jhist) = _run_both(method, "semi_async",
                                                  "cellular-flaky")
    part = np.asarray(hist.participation)
    assert part.shape == (ROUNDS, N_CLIENTS)
    assert not part.all()           # stragglers: some round was partial
    np.testing.assert_array_equal(part, np.asarray(jhist.participation))
    assert hist.assignments == jhist.assignments
    np.testing.assert_allclose(hist.trace.counts,
                               np.asarray(jhist.trace.counts), rtol=0,
                               atol=1e-5)
    for got, want in ((hist.sim_times, jhist.sim_times),
                      (hist.wan_bytes, jhist.wan_bytes),
                      (hist.edge_bytes, jhist.edge_bytes)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(hist.train_loss, jhist.train_loss, rtol=1e-4)
    np.testing.assert_allclose(hist.test_acc, jhist.test_acc, rtol=0,
                               atol=2.0 / N_TEST)
    _assert_theta_close(theta, theta_ref)


@pytest.mark.parametrize("method", ["coalition", "fedavg", "fedavg_trimmed"])
def test_semi_async_on_ideal_equals_scan_bit_for_bit(method):
    """On the ideal fleet every substrate step is an exact no-op: θ and
    every trace field both engines have are equal bit for bit."""
    data, (xte, yte) = _data()
    model = zoo.make_model("cnn")
    xte_t, yte_t = torch.from_numpy(xte), torch.from_numpy(yte)
    cd = {k: torch.from_numpy(v) for k, v in data.items()}
    out = {}
    for engine in ("scan", "semi_async"):
        gen = torch.Generator().manual_seed(5)
        params = model.init(gen)
        cfg = FederationConfig(n_clients=N_CLIENTS, n_coalitions=K,
                               rounds=ROUNDS, method=method, engine=engine,
                               client=ClientConfig(epochs=EPOCHS))
        out[engine] = Federation(
            model, lambda p: model.accuracy(p, xte_t, yte_t), cfg,
        ).run(params, cd, generator=gen)
    (gp_s, hist_s), (gp_a, hist_a) = out["scan"], out["semi_async"]
    for name in gp_s:
        assert torch.equal(gp_s[name], gp_a[name]), name
    for field in ("loss", "acc", "assignment", "counts", "churn", "entropy",
                  "radius", "drift"):
        np.testing.assert_array_equal(getattr(hist_a.trace, field),
                                      getattr(hist_s.trace, field),
                                      err_msg=field)
    assert np.all(hist_a.trace.participation == 1.0)
    assert hist_a.sim_times == [0.0] * ROUNDS
    assert hist_s.trace.sim_time is None


def test_federation_validates_engine_fleet_and_rho():
    model = zoo.make_model("cnn")
    for cfg in (FederationConfig(engine="event_driven"),
                FederationConfig(engine="nope"),
                FederationConfig(sim=tsim.SimConfig(fleet="nope")),
                FederationConfig(sim=tsim.SimConfig(rho=1.5)),
                FederationConfig(sim=tsim.SimConfig(rho=float("nan"))),
                FederationConfig(sim=tsim.SimConfig(scenario="nope")),
                FederationConfig(backend="nope")):
        with pytest.raises(ValueError):
            Federation(model, lambda p: 0.0, cfg)


def _tiny_args(clients=2):
    return ["--mode", "fl", "--rounds", "1", "--clients", str(clients),
            "--coalitions", "2", "--local-epochs", "1", "--n-train", "40",
            "--n-test", "20"]


def test_cli_prints_reference_keys(capsys):
    want = jtrain.run_fl(jtrain.build_parser().parse_args(
        _tiny_args() + ["--backend", "xla"]))
    capsys.readouterr()
    ttrain.main(_tiny_args() + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == (set(want) - {"rounds"}) | {"device"}
    assert printed["device"] == "cpu"
    assert len(printed["test_acc"]) == 1


@pytest.mark.parametrize("extra", [
    ["--method", "fedavg"],
    ["--method", "fedavg_weighted", "--client-weights", "1,2,3"],
    ["--method", "fedavg_trimmed", "--trim", "1"],
    ["--engine", "semi_async", "--fleet", "cellular-flaky", "--rounds", "2"],
    ["--method", "fedavg", "--engine", "semi_async", "--fleet", "uniform",
     "--deadline", "3"]], ids=lambda e: "-".join(a.strip("-") for a in e))
def test_cli_new_rules_and_engine_print_reference_keys(capsys, extra):
    args = _tiny_args(clients=3) + extra
    want = jtrain.run_fl(jtrain.build_parser().parse_args(
        args + ["--backend", "xla"]))
    capsys.readouterr()
    ttrain.main(args + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == (set(want) - {"rounds"}) | {"device"}
    assert printed["method"] == want["method"]
    assert printed["strategy_extras"] == want["strategy_extras"]
    if "semi_async" in extra:
        assert 0.0 < printed["mean_participation"] <= 1.0
        assert printed["wan_MB"] > 0 and printed["fleet"] == want["fleet"]


@pytest.mark.parametrize("bad", [["--method", "coalition", "--trim", "1"],
                                 ["--method", "fedavg", "--client-weights",
                                  "1,2,3"],
                                 ["--method", "fedavg", "--top-m", "1"]])
def test_cli_rejects_a_flag_the_method_does_not_take(bad):
    for main in (lambda a: jtrain.run_fl(jtrain.build_parser().parse_args(a)),
                 lambda a: ttrain.main(a + ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            main(_tiny_args(clients=3) + bad)
        assert exc.value.code not in (0, None)


def test_cli_without_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train"] + _tiny_args(),
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert proc.stdout == ""
