"""The port's adversarial and privacy tier against the reference's.

- ``adversary_mask`` is numpy on both sides: on the reference's device
  tables (carried) it must equal the reference's bit for bit.
- Each attack hook on the same numpy inputs (and, for ``gaussian_noise``,
  the reference's noise of the same key injected) must equal the
  reference's exactly (the same f32 ops elementwise), and be the identity
  bit for bit where the mask is 0.
- ``quarantine_fraction`` and ``contamination`` (O(N·K) f32 sums of the
  same terms) within rtol 1e-6.
- An attack at ``adv_frac = 0`` gives the clean run bit for bit on
  ``scan``, ``semi_async`` and ``event_driven`` (port only).
- A ``sign_flip`` federation (6 clients, 3 compromised) and a
  ``gaussian_noise`` one (2 compromised), the reference's draws and attack
  noise injected, match the reference per round: adversary masks,
  assignments and quarantine equal, counts and contamination within rtol
  1e-6, θ and accuracy within the federation tests' bounds.  Their
  coalitions never hold exactly two members: two equal-mass members are
  equidistant from their barycenter, so rounding alone would elect the
  medoid (ROADMAP §C); ``sign_flip`` with 2 compromised forms such a pair.
- The DP path on the (N, D) rows of W against the reference's leaf-wise
  ``_privatize`` with its noise injected, within rtol 1e-6 (the clip norm
  sums in another order); ``gaussian_epsilon`` equal over a grid.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro.core import client as jclient
from repro.core import pytree as jpt
from repro.obs import metrics as jmetrics
from repro.obs import privacy as jprivacy
from repro_torch import carry
from repro_torch import sim as tsim
from repro_torch.core import client as tclient
from repro_torch.core.client import ClientConfig
from repro_torch.core.server import (TIMING_FIELDS, Federation,
                                     FederationConfig)
from repro_torch.models import zoo
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import privacy as tprivacy
from test_torch_federation import (EPOCHS, K, N_CLIENTS, N_TEST,
                                   PARITY_THREADS, ROUNDS,
                                   _assert_theta_close, _data, _run_both,
                                   reference_draws)
from repro_torch.testing import cap_cpu_threads, torch_threads

cap_cpu_threads()

RTOL = 1e-6
ATTACKS = ("gaussian_noise", "label_flip", "scale_update", "sign_flip")


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_attack_registry_matches_reference():
    assert tsim.available_attacks() == jsim.available_attacks() == ATTACKS
    assert tsim.ATTACK_STREAM == jsim.ATTACK_STREAM
    for name in ATTACKS:
        assert tsim.make_attack(name).params == jsim.make_attack(name).params
    with pytest.raises(ValueError, match="unknown attack"):
        tsim.make_attack("telepathy")
    with pytest.raises(ValueError, match="boost"):
        tsim.make_attack("scale_update", boost=0.0)
    with pytest.raises(ValueError, match="sigma"):
        tsim.make_attack("gaussian_noise", sigma=-1.0)


@pytest.mark.parametrize("fleet,n,adv_frac,rho_adv,seed", [
    ("cellular-flaky", 10, 0.2, 0.0, 0), ("cellular-flaky", 16, 0.3, 1.0, 1),
    ("cellular-flaky", 16, 0.3, -1.0, 2), ("lognormal-edge", 32, 0.25, 0.5, 3),
    ("lognormal-edge", 32, 0.5, -0.4, 4), ("ideal", 8, 0.4, 0.7, 5),
    ("uniform", 12, 0.0, 0.0, 6), ("uniform", 100, 0.07, -0.9, 7)])
def test_adversary_mask_matches_reference(fleet, n, adv_frac, rho_adv, seed):
    jfleet = jsim.make_fleet(fleet, n, seed=seed)
    want = jsim.adversary_mask(jfleet, adv_frac, rho_adv, seed=seed)
    got = tsim.adversary_mask(carry.fleet_from_jax(jfleet), adv_frac, rho_adv,
                              seed=seed)
    assert got.dtype == bool and got.sum() == round(adv_frac * n)
    np.testing.assert_array_equal(got, want)
    for bad in ((1.0, 0.0), (0.2, 1.5)):
        with pytest.raises(ValueError):
            tsim.adversary_mask(carry.fleet_from_jax(jfleet), *bad)


@pytest.mark.parametrize("name", ATTACKS)
def test_attack_hooks_match_reference_and_gate_on_the_mask(name):
    n, d = 8, 300
    w, theta = _rand((n, d), 1), _rand((d,), 2)
    adv = (np.arange(n) % 3 == 0).astype(np.float32)
    key = jax.random.key(7)
    noise = np.asarray(jax.random.normal(key, (n, d), jnp.float32))
    jatk, tatk = jsim.make_attack(name), tsim.make_attack(name)
    want = np.asarray(jatk.transform(jnp.asarray(w), jnp.asarray(theta),
                                     jnp.asarray(adv), key))
    tw = torch.from_numpy(w)
    got = tatk.transform(tw, torch.from_numpy(theta), torch.from_numpy(adv),
                         lambda: torch.tensor(noise))
    np.testing.assert_array_equal(got.numpy(), want)
    clean = tatk.transform(tw, torch.from_numpy(theta), torch.zeros(n),
                           lambda: torch.tensor(noise))
    assert torch.equal(clean, tw)
    for y in (np.arange(n * 5, dtype=np.int32).reshape(n, 5) % 10,
              _rand((n, 5), 3)):
        data = {"x": _rand((n, 5, 4), 4), "y": y}
        want = jatk.poison({k: jnp.asarray(v) for k, v in data.items()},
                           jnp.asarray(adv))
        tdata = {k: torch.from_numpy(v) for k, v in data.items()}
        got = tatk.poison(tdata, torch.from_numpy(adv))
        for k in data:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
            assert got[k].dtype == tdata[k].dtype
        clean = tatk.poison(tdata, torch.zeros(n))
        for k in data:
            assert torch.equal(clean[k], tdata[k])


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quarantine_and_contamination_match_reference(k, seed):
    n = 12
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, k, n)
    med_d2 = np.abs(_rand((n, k), seed + 10)) * 50.0
    for adv in (np.zeros(n, np.float32), (rng.random(n) < 0.3).astype(
            np.float32), (assignment == 0).astype(np.float32)):
        ja, jadv = jnp.asarray(assignment, jnp.int32), jnp.asarray(adv)
        ta, tadv = torch.from_numpy(assignment), torch.from_numpy(adv)
        got = tmetrics.quarantine_fraction(ta, tadv, k)
        want = jmetrics.quarantine_fraction(ja, jadv, k)
        np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
        got = tmetrics.contamination(torch.from_numpy(med_d2), ta, tadv, k)
        want = jmetrics.contamination(jnp.asarray(med_d2), ja, jadv, k)
        np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
        assert got.dtype == torch.float32
    pure = (assignment == 0).astype(np.float32)
    assert tmetrics.contamination(torch.from_numpy(med_d2),
                                  torch.from_numpy(assignment),
                                  torch.from_numpy(pure), k).item() == 0.0


def _port_run(engine, attack=None, adv_frac=0.0, **sim_kw):
    data, (xte, yte) = _data()
    model = zoo.make_model("cnn")
    xte_t, yte_t = torch.from_numpy(xte), torch.from_numpy(yte)
    gen = torch.Generator().manual_seed(3)
    params = model.init(gen)
    cfg = FederationConfig(n_clients=N_CLIENTS, n_coalitions=K,
                           rounds=ROUNDS, engine=engine, attack=attack,
                           adv_frac=adv_frac,
                           client=ClientConfig(epochs=EPOCHS),
                           sim=tsim.SimConfig(**sim_kw))
    return Federation(model, lambda p: model.accuracy(p, xte_t, yte_t),
                      cfg).run(params, {k: torch.from_numpy(v)
                                        for k, v in data.items()},
                               generator=gen)


@pytest.mark.parametrize("engine,sim_kw", [
    ("scan", {}),
    ("semi_async", {"fleet": "cellular-flaky"}),
    ("event_driven", {"fleet": "cellular-flaky", "energy_budget": 50.0})])
def test_zero_adversaries_equal_the_clean_run_bit_for_bit(engine, sim_kw):
    gp_c, hist_c = _port_run(engine, **sim_kw)
    gp_a, hist_a = _port_run(engine, "gaussian_noise", 0.0, **sim_kw)
    for name in gp_c:
        assert torch.equal(gp_c[name], gp_a[name]), name
    for field in hist_c.trace._fields:
        if field in TIMING_FIELDS:
            continue
        want = getattr(hist_c.trace, field)
        if want is not None:
            np.testing.assert_array_equal(getattr(hist_a.trace, field), want,
                                          err_msg=field)
    assert hist_c.adversary is None
    assert not np.any(hist_a.trace.adversary)
    assert hist_a.quarantine == [0.0] * len(hist_a.rounds)
    assert hist_a.contamination == [0.0] * len(hist_a.rounds)


@pytest.mark.parametrize("attack,adv_frac,n_adv", [("sign_flip", 0.5, 3),
                                                   ("gaussian_noise", 0.34,
                                                    2)])
def test_attacked_federation_matches_reference(attack, adv_frac, n_adv):
    fed_kw = {"attack": attack, "adv_frac": adv_frac}
    with torch_threads(PARITY_THREADS):
        (theta, hist), (theta_ref, jhist) = _run_both(
            fed_kw=fed_kw, attack_noise=attack == "gaussian_noise")
    adv = np.asarray(hist.adversary)
    assert adv.shape == (ROUNDS, N_CLIENTS)
    assert adv.sum(axis=1).tolist() == [n_adv] * ROUNDS
    assert min(np.asarray(hist.counts).ravel()) != 2
    np.testing.assert_array_equal(adv, np.asarray(jhist.adversary))
    assert hist.assignments == jhist.assignments
    np.testing.assert_array_equal(hist.quarantine, jhist.quarantine)
    for got, want in ((hist.trace.counts, jhist.trace.counts),
                      (hist.contamination, jhist.contamination),
                      (hist.radius, jhist.radius)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=RTOL, atol=0)
    np.testing.assert_allclose(hist.test_acc, jhist.test_acc, rtol=0,
                               atol=2.0 / N_TEST)
    _assert_theta_close(theta, theta_ref)


@pytest.mark.parametrize("clip,sigma", [(1.0, 0.0), (1.0, 0.5), (0.05, 2.0),
                                        (float("inf"), 0.3), (1e3, 0.0)])
def test_privatize_matches_reference(clip, sigma):
    """The reference clips and noises one client's update leaf by leaf with
    the noise of ``split(key, n_leaves)``; the port does every row of W at
    once with the same noise laid out in W's columns."""
    n = 5
    start = {"a": _rand((3, 4), 1), "b": {"c": _rand((7,), 2)}}
    cfg_j = jclient.ClientConfig(dp_clip=clip, dp_sigma=sigma)
    rows, noise, want = [], [], []
    for i in range(n):
        trained = jax.tree.map(
            lambda s, i=i: s + 0.3 * (i + 1) * _rand(s.shape, 10 + i), start)
        key = jax.random.key(i)
        leaves = jax.tree.leaves(trained)
        noise.append(np.concatenate([
            np.asarray(jax.random.normal(k, leaf.shape, jnp.float32)).ravel()
            for k, leaf in zip(jax.random.split(key, len(leaves)), leaves)]))
        rows.append(np.asarray(jpt.flatten(trained)))
        want.append(np.asarray(jpt.flatten(jclient._privatize(
            jax.tree.map(jnp.asarray, start),
            jax.tree.map(jnp.asarray, trained), key, cfg_j))))
    theta = torch.from_numpy(np.asarray(jpt.flatten(start)))
    cfg = ClientConfig(dp_clip=clip, dp_sigma=sigma)
    got = tclient.privatize(torch.from_numpy(np.stack(rows)), theta, cfg,
                            noise=torch.from_numpy(np.stack(noise)))
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=RTOL,
                               atol=1e-7)
    if math.isfinite(clip) and sigma == 0.0:
        norms = torch.linalg.vector_norm(got - theta, dim=1)
        assert torch.all(norms <= clip * (1 + 1e-6))
    w = torch.from_numpy(np.stack(rows))
    assert tclient.privatize(w, theta, ClientConfig()) is w


def test_injected_dp_noise_reaches_every_round():
    """``Draws.dp_noise`` is what the DP path adds: zero noise at sigma 0.5
    gives the sigma-0 run bit for bit, and the drawn noise does not."""
    data, _ = _data()
    model = zoo.make_model("cnn")
    cd = {k: torch.from_numpy(v) for k, v in data.items()}
    params = model.init(torch.Generator().manual_seed(0))
    draws = reference_draws(jax.random.key(1), data["y"].shape[1])
    d = sum(v.numel() for v in params.values())
    zeros = [np.zeros((N_CLIENTS, d), np.float32)] * ROUNDS
    runs = []
    for sigma, noise in ((0.0, None), (0.5, zeros), (0.5, None)):
        cfg = FederationConfig(n_clients=N_CLIENTS, n_coalitions=K,
                               rounds=ROUNDS, client=ClientConfig(
                                   epochs=EPOCHS, dp_clip=1.0,
                                   dp_sigma=sigma))
        runs.append(Federation(model, lambda p: 0.0, cfg).run(
            params, cd, draws=draws._replace(dp_noise=noise))[0])
    (clean, zero, drawn) = runs
    for name in clean:
        assert torch.equal(clean[name], zero[name]), name
    assert not all(torch.equal(clean[n], drawn[n]) for n in clean)


def test_validate_dp_matches_reference():
    for clip, sigma in ((1.0, -0.1), (0.0, 1.0), (-1.0, 0.0),
                        (1.0, float("inf")), (1.0, float("nan"))):
        for mod in (jclient, tclient):
            with pytest.raises(ValueError):
                mod.validate_dp(mod.ClientConfig(dp_clip=clip,
                                                 dp_sigma=sigma))
    for clip, sigma in ((1.0, 0.0), (float("inf"), 0.5), (2.0, 1.0)):
        tclient.validate_dp(ClientConfig(dp_clip=clip, dp_sigma=sigma))
        assert tclient.dp_enabled(ClientConfig(dp_clip=clip, dp_sigma=sigma))
    assert not tclient.dp_enabled(ClientConfig())


def test_gaussian_epsilon_matches_reference():
    for sigma in (0.0, 0.3, 1.0, 4.0):
        for rounds in (0, 1, 30, 1000):
            for q in (0.0, 0.1, 1.0):
                for delta in (1e-5, 1e-3):
                    assert tprivacy.gaussian_epsilon(
                        sigma, rounds, delta=delta, q=q) == \
                        jprivacy.gaussian_epsilon(sigma, rounds, delta=delta,
                                                  q=q)
    for bad in ({"sigma": -1.0, "rounds": 1}, {"sigma": 1.0, "rounds": -1},
                {"sigma": 1.0, "rounds": 1, "q": 1.5},
                {"sigma": 1.0, "rounds": 1, "delta": 0.0}):
        with pytest.raises(ValueError):
            tprivacy.gaussian_epsilon(**bad)
