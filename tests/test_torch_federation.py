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
from repro.models import cnn as jcnn
from repro.sim import scenarios
from repro_torch import carry
from repro_torch.core import pytree as tpt
from repro_torch.core.client import ClientConfig
from repro_torch.core.server import Draws, Federation, FederationConfig
from repro_torch.launch import train as ttrain
from repro_torch.models import zoo

ROOT = Path(__file__).resolve().parent.parent
N_CLIENTS, K, ROUNDS, EPOCHS, N_TRAIN, N_TEST = 6, 2, 3, 1, 600, 200
THETA_TOL = 1e-4


def reference_draws(key, n_local: int) -> Draws:
    """The shuffles and Step-I permutation the reference draws from ``key``."""
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
    return Draws(shuffles=rounds, center_perm=center_perm)


def test_seeded_federation_matches_reference():
    (xtr, ytr) = synthetic.digits(N_TRAIN, seed=0)
    (xte, yte) = synthetic.digits(N_TEST, seed=1)
    scn = scenarios.make_scenario("independent", ytr, N_CLIENTS,
                                  regime="shard", seed=0)
    data = loader.client_datasets(xtr, ytr, scn.index_matrix)
    init = jcnn.init(jax.random.key(0))
    key = jax.random.key(1)

    jcfg = JFederationConfig(n_clients=N_CLIENTS, n_coalitions=K,
                             rounds=ROUNDS, client=JClientConfig(epochs=EPOCHS))
    xte_j, yte_j = jnp.asarray(xte), jnp.asarray(yte)
    jgp, jhist = JFederation(
        jcnn.loss_fn, lambda p: jcnn.accuracy(p, xte_j, yte_j), jcfg,
    ).run(init, jax.tree.map(jnp.asarray, data), key)

    model = zoo.make_model("cnn")
    xte_t, yte_t = torch.from_numpy(xte), torch.from_numpy(yte)
    cfg = FederationConfig(n_clients=N_CLIENTS, n_coalitions=K, rounds=ROUNDS,
                           client=ClientConfig(epochs=EPOCHS))
    gp, hist = Federation(
        model, lambda p: model.accuracy(p, xte_t, yte_t), cfg,
    ).run(carry.params_from_jax(jax.tree.map(np.asarray, init)),
          {k: torch.from_numpy(v) for k, v in data.items()},
          draws=reference_draws(key, data["y"].shape[1]))

    assert hist.assignments == jhist.assignments
    assert hist.counts == jhist.counts
    np.testing.assert_allclose(hist.test_acc, jhist.test_acc, rtol=0,
                               atol=2.0 / N_TEST)
    theta_ref = np.asarray(jpt.flatten(jgp))
    theta = tpt.flatten(gp, model.layout).numpy()
    scale = np.abs(theta_ref).max()
    np.testing.assert_allclose(theta / scale, theta_ref / scale, rtol=0,
                               atol=THETA_TOL)
    assert hist.churn[0] == 0.0 and len(hist.drift) == ROUNDS
    assert all(t >= 0 for t in hist.trace.local_s)


def _tiny_args():
    return ["--mode", "fl", "--rounds", "1", "--clients", "2",
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
