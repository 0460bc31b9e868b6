"""The port's client side against the reference's, on carried weights.

The reference's CNN init is carried into the port (``repro_torch.carry``),
and both packages see the same numpy data and the same per-epoch shuffles
(the reference's threefry permutations, injected).  Checked: CNN logits and
loss, the column order of the client weight matrix (exactly equal: it is a
pure permutation of the same numbers), one ``client_update`` with and
without a ragged tail, plain SGD, and the numpy data pipeline
(synthetic digits, every partition regime, the ``independent`` scenario)
array-equal at the same seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as jclient
from repro.core import pytree as jpt
from repro.data import loader as jloader
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.models import cnn as jcnn
from repro.optim import optimizers as jopt
from repro.sim import scenarios as jscenarios
from repro_torch import carry
from repro_torch.core import client as tclient
from repro_torch.core import pytree as tpt
from repro_torch.data import loader as tloader
from repro_torch.data import partition as tpartition
from repro_torch.data import synthetic as tsynthetic
from repro_torch.models import cnn as tcnn
from repro_torch.optim import optimizers as topt
from repro_torch.sim import scenarios as tscenarios
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

#: f32 training drifts apart between XLA's and PyTorch's convolutions; one
#: client_update of 6 SGD steps moved W by at most 5.8e-5 of max|W| apart
#: when this test was written (CPU, jax 0.9.0, torch 2.13)
UPDATE_TOL = 2e-4


def _params(seed=0):
    tree = jax.tree.map(np.asarray, jcnn.init(jax.random.key(seed)))
    return tree, carry.params_from_jax(tree)


def test_cnn_logits_and_loss_on_carried_params():
    tree, params = _params()
    x, y = tsynthetic.digits(7)
    logits_ref = np.asarray(jcnn.apply(tree, jnp.asarray(x)))
    logits = tcnn.apply(params, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(logits, logits_ref, rtol=1e-5, atol=1e-5)
    loss_ref = float(jcnn.loss_fn(tree, {"x": jnp.asarray(x),
                                         "y": jnp.asarray(y)}))
    loss = float(tcnn.loss_fn(params, {"x": torch.from_numpy(x),
                                       "y": torch.from_numpy(y)}))
    assert loss == pytest.approx(loss_ref, rel=1e-5)
    assert tcnn.CNNConfig().n_params() == jcnn.CNNConfig().n_params()


def test_carry_round_trip():
    tree, params = _params(3)
    back = carry.params_to_jax(params)
    for name in ("conv1", "conv2", "fc1", "fc2"):
        for leaf in ("b", "w"):
            np.testing.assert_array_equal(back[name][leaf], tree[name][leaf])


def test_client_matrix_columns_equal_reference():
    trees = [_params(s) for s in range(3)]
    stacked_ref = jpt.stack_clients([jax.tree.map(jnp.asarray, t)
                                     for t, _ in trees])
    want = np.array(jpt.client_matrix(stacked_ref))
    stacked = {k: torch.stack([p[k] for _, p in trees])
               for k in trees[0][1]}
    got = tpt.client_matrix(stacked, tcnn.REF_LAYOUT).numpy()
    assert got.shape == (3, 582_026)
    np.testing.assert_array_equal(got, want)
    back = tpt.matrix_to_stacked(torch.from_numpy(want), tcnn.REF_LAYOUT,
                                 trees[0][1])
    for k, v in stacked.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())
    theta = tpt.flatten(trees[1][1], tcnn.REF_LAYOUT)
    np.testing.assert_array_equal(theta.numpy(), want[1])
    again = tpt.unflatten(theta, tcnn.REF_LAYOUT, trees[0][1])
    for k, v in trees[1][1].items():
        np.testing.assert_array_equal(again[k].numpy(), v.numpy())


@pytest.mark.parametrize("n", [20, 23])      # 23: a ragged tail of 3
def test_client_update_matches_reference(n):
    tree, params = _params(1)
    x, y = tsynthetic.digits(n, seed=2)
    cfg = jclient.ClientConfig(epochs=2, batch_size=10, lr=0.05)
    key = jax.random.key(7)
    new_ref, loss_ref = jclient.client_update(
        jcnn.loss_fn, jax.tree.map(jnp.asarray, tree),
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, key, cfg)
    # the reference's draws: client.py splits the key per epoch
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in jax.random.split(key, cfg.epochs)])
    new, loss = tclient.client_update(
        tcnn.loss_fn, params, {"x": torch.from_numpy(x),
                               "y": torch.from_numpy(y)},
        torch.from_numpy(perms), tclient.ClientConfig(epochs=2, lr=0.05))
    w_ref = np.asarray(jpt.flatten(new_ref))
    w = tpt.flatten(new, tcnn.REF_LAYOUT).detach().numpy()
    scale = np.abs(w_ref).max()
    np.testing.assert_allclose(w / scale, w_ref / scale, rtol=0,
                               atol=UPDATE_TOL)
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-4)
    assert np.abs(w - tpt.flatten(params, tcnn.REF_LAYOUT).numpy()).max() > 0


def test_local_phase_is_client_update_per_client():
    _, params = _params(2)
    xs, ys = zip(*(tsynthetic.digits(12, seed=s) for s in range(2)))
    data = {"x": torch.from_numpy(np.stack(xs)),
            "y": torch.from_numpy(np.stack(ys))}
    rng = np.random.default_rng(0)
    perms = torch.from_numpy(np.stack([[rng.permutation(12)] for _ in "ab"]))
    cfg = tclient.ClientConfig(epochs=1)
    stacked, losses = tclient.local_phase(tcnn.loss_fn, params, data, perms,
                                          cfg)
    for c in range(2):
        one, loss = tclient.client_update(
            tcnn.loss_fn, params, {k: v[c] for k, v in data.items()},
            perms[c], cfg)
        for k in one:
            np.testing.assert_allclose(stacked[k][c].detach().numpy(),
                                       one[k].detach().numpy(), rtol=1e-5,
                                       atol=1e-6)
        assert float(losses[c]) == pytest.approx(float(loss), rel=1e-5)


def test_dp_waits_for_its_slice():
    """The DP path has landed: validate_dp takes a DP configuration and, as
    the reference's, rejects only bad values."""
    tclient.validate_dp(tclient.ClientConfig(dp_sigma=1.0))
    tclient.validate_dp(tclient.ClientConfig(dp_clip=1.0, dp_sigma=0.5))
    with pytest.raises(ValueError, match="dp_sigma"):
        tclient.validate_dp(tclient.ClientConfig(dp_sigma=-1.0))
    with pytest.raises(ValueError, match="dp_clip"):
        tclient.validate_dp(tclient.ClientConfig(dp_clip=0.0))


@pytest.mark.parametrize("lr", [0.01, 0.1, 0.5])
def test_sgd_matches_reference(lr):
    rng = np.random.default_rng(1)
    p = {"a": rng.standard_normal(5).astype(np.float32)}
    grads = [{"a": rng.standard_normal(5).astype(np.float32)} for _ in "xyz"]
    jo = jopt.sgd(lr)
    to = topt.sgd(lr)
    jp, tp = {"a": jnp.asarray(p["a"])}, {"a": torch.from_numpy(p["a"])}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update({"a": jnp.asarray(g["a"])}, js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update({"a": torch.from_numpy(g["a"])}, ts, tp)
        tp = topt.apply_updates(tp, tu)
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                               rtol=1e-6)


def test_digits_equal_reference():
    for got, want in zip(tsynthetic.digits(50, seed=3),
                         jsynthetic.digits(50, seed=3)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("regime", sorted(jpartition.available_regimes()))
def test_partitions_equal_reference(regime):
    assert tpartition.available_regimes() == jpartition.available_regimes()
    _, y = jsynthetic.digits(400, seed=0)
    np.testing.assert_array_equal(
        tpartition.partition(regime, y, 5, seed=4),
        jpartition.partition(regime, y, 5, seed=4))


def test_independent_scenario_and_datasets_equal_reference():
    x, y = jsynthetic.digits(300, seed=0)
    got = tscenarios.make_scenario("independent", y, 6, regime="shard",
                                   seed=2)
    want = jscenarios.make_scenario("independent", y, 6, regime="shard",
                                    seed=2)
    np.testing.assert_array_equal(got.index_matrix, want.index_matrix)
    assert got.metadata["spearman"] == want.metadata["spearman"]
    for k, v in tloader.client_datasets(x, y, got.index_matrix).items():
        np.testing.assert_array_equal(
            v, jloader.client_datasets(x, y, want.index_matrix)[k])
    with pytest.raises(ValueError):
        tscenarios.make_scenario("independent", y, 6, rho=0.5)
