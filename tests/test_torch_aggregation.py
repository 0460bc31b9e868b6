"""The port's aggregation rules, comm model and strategies against the
reference's (``repro.core.aggregation``, ``repro.core.strategies``).

The same numpy inputs go through both packages.  The four aggregation
functions agree within 1e-6 of the max |θ|; an all-ones mask is
``fedavg`` exactly (``torch.equal``), an all-zero mask gives zeros, and the
trim is clamped to what the present rows afford.  The comm model returns
the reference's numbers and raises where it does.  Every registered rule's
``round`` is held to the reference's, with and without a mask (binary and
staleness-fractional): θ within 1e-6 of its max, assignments and centers
equal, counts within 1e-5.  The coalition cases use three separated
clusters of four clients, at most one of them at zero mass, so that no
election is a tie.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import coalitions as jco
from repro.core import strategies as jstr
from repro_torch.core import aggregation as tagg
from repro_torch.core import coalitions as tco
from repro_torch.core import strategies as tstr
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

TOL = 1e-6
N, D = 7, 300
#: (N,) participation/staleness masks: binary, fractional, with absentees
MASKS = {
    "ones": np.ones(N, np.float32),
    "binary": np.array([1, 0, 1, 1, 0, 1, 1], np.float32),
    "stale": (1.0 + np.array([0, 1, 2, 3, 4, 0, 1], np.float32)) ** -0.5,
    "mixed": np.array([1, 0, 0.5, 0.25, 1, 0, 0.7], np.float32),
    "one": np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
}


def _w(n=N, d=D, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def test_fedavg_matches_reference():
    w = _w()
    _close(tagg.fedavg(torch.from_numpy(w)).numpy(),
           jagg.fedavg(jnp.asarray(w)))
    c = np.arange(1, N + 1, dtype=np.float32)
    _close(tagg.fedavg(torch.from_numpy(w), torch.from_numpy(c)).numpy(),
           jagg.fedavg(jnp.asarray(w), jnp.asarray(c)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_fedavg_masked_matches_reference(mask, weighted):
    w, m = _w(seed=1), MASKS[mask]
    c = np.linspace(0.5, 2.0, N).astype(np.float32) if weighted else None
    got = tagg.fedavg_masked(torch.from_numpy(w), torch.from_numpy(m),
                             None if c is None else torch.from_numpy(c))
    want = jagg.fedavg_masked(jnp.asarray(w), jnp.asarray(m),
                              None if c is None else jnp.asarray(c))
    _close(got.numpy(), want)


def test_fedavg_masked_all_ones_is_fedavg_bit_for_bit():
    w = torch.from_numpy(_w(seed=2))
    ones = torch.ones(N)
    assert torch.equal(tagg.fedavg_masked(w, ones), tagg.fedavg(w))
    c = torch.linspace(0.5, 2.0, N)
    assert torch.equal(tagg.fedavg_masked(w, ones, c), tagg.fedavg(w, c))


def test_all_zero_mask_gives_zeros():
    w = torch.from_numpy(_w(seed=3))
    zero = torch.zeros(N)
    for got in (tagg.fedavg_masked(w, zero),
                tagg.fedavg_masked(w, zero, torch.ones(N)),
                tagg.trimmed_mean_masked(w, 2, zero)):
        assert torch.isfinite(got).all() and torch.equal(
            got, torch.zeros(D))


@pytest.mark.parametrize("trim", [0, 1, 2, 3])
def test_trimmed_mean_matches_reference(trim):
    w = _w(seed=4)
    _close(tagg.trimmed_mean(torch.from_numpy(w), trim).numpy(),
           jagg.trimmed_mean(jnp.asarray(w), trim))


@pytest.mark.parametrize("trim", [0, 1, 2, 3])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_trimmed_mean_masked_matches_reference(mask, trim):
    w, m = _w(seed=5), MASKS[mask]
    _close(tagg.trimmed_mean_masked(torch.from_numpy(w), trim,
                                    torch.from_numpy(m)).numpy(),
           jagg.trimmed_mean_masked(jnp.asarray(w), trim, jnp.asarray(m)))


def test_trimmed_mean_masked_clamps_the_trim():
    """Three present rows afford a trim of 1 however much is asked, and the
    kept row is their median; all present equals the unmasked rule."""
    w = torch.from_numpy(_w(seed=6))
    m = torch.tensor([0, 1, 0, 1, 0, 1, 0], dtype=torch.float32)
    median = torch.median(w[[1, 3, 5]], dim=0).values
    for trim in (1, 2, 3):
        assert torch.equal(tagg.trimmed_mean_masked(w, trim, m), median)
    _close(tagg.trimmed_mean_masked(w, 2, torch.ones(N)).numpy(),
           tagg.trimmed_mean(w, 2).numpy())
    with pytest.raises(ValueError):
        tagg.trimmed_mean_masked(w, 4, m)
    with pytest.raises(ValueError):
        tagg.trimmed_mean(w, -1)


@pytest.mark.parametrize("args", [(10, 3, 582_026, 4), (7, 7, 100, 2),
                                  (1, 1, 1, 1)])
def test_comm_model_matches_reference(args):
    n, k, d, bpp = args
    assert tagg.comm_fedavg(n, d, bpp) == tuple(jagg.comm_fedavg(n, d, bpp))
    assert (tagg.comm_coalition(n, k, d, bpp)
            == tuple(jagg.comm_coalition(n, k, d, bpp)))
    assert tagg.wan_savings(n, k) == jagg.wan_savings(n, k)


@pytest.mark.parametrize("call", [
    lambda m: m.comm_fedavg(0, 10), lambda m: m.comm_fedavg(3, 0),
    lambda m: m.comm_fedavg(3, 10, 0), lambda m: m.comm_coalition(3, 4, 10),
    lambda m: m.comm_coalition(3, 0, 10), lambda m: m.wan_savings(2, 3),
    lambda m: m.wan_savings(0, 1)])
def test_comm_model_raises_as_reference(call):
    with pytest.raises(ValueError):
        call(jagg)
    with pytest.raises(ValueError):
        call(tagg)


# --- strategies ------------------------------------------------------------------

NC, K = 12, 3
CENTERS = [0, 1, 2]
#: masks over the 12 clients of three clusters of four (client i is in
#: cluster i % 3): each cluster keeps at least three clients of positive mass
RULE_MASKS = {
    None: None,
    "binary": np.array([1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0], np.float32),
    "stale": ((1.0 + np.arange(NC) % 5) ** -0.5).astype(np.float32),
    "mixed": np.array([1, 0.5, 1, 0.25, 0, 1, 0.7, 1, 1, 0.3, 1, 1],
                      np.float32),
}
RULES = [("fedavg", {}), ("fedavg_weighted", {"client_weights": "c"}),
         ("fedavg_trimmed", {"trim": 2}), ("coalition", {}),
         ("coalition", {"client_weights": "c"}), ("coalition_topk", {}),
         ("coalition_topk", {"top_m": 1, "client_weights": "c"})]


def _clusters(seed=7):
    rng = np.random.default_rng(seed)
    owner = np.arange(NC) % K
    mu = np.array([-3.0, 0.0, 3.0], np.float32)[owner][:, None]
    return (mu + 0.5 * rng.standard_normal((NC, 200))).astype(np.float32)


def _make_both(name, extra):
    c = np.linspace(0.5, 1.5, NC).astype(np.float32)
    j_extra = {k: (jnp.asarray(c) if v == "c" else v)
               for k, v in extra.items()}
    t_extra = {k: (torch.from_numpy(c) if v == "c" else v)
               for k, v in extra.items()}
    groups = K if name.startswith("coalition") else 1
    js = jstr.make_strategy(name, n_clients=NC, n_coalitions=groups,
                            backend="xla", **j_extra)
    ts = tstr.make_strategy(name, n_clients=NC, n_coalitions=groups,
                            backend="stream", **t_extra)
    return js, ts


@pytest.mark.parametrize("mask", list(RULE_MASKS),
                         ids=lambda m: str(m))
@pytest.mark.parametrize("name,extra", RULES,
                         ids=[f"{n}-{'-'.join(e)}" for n, e in RULES])
def test_rule_round_matches_reference(name, extra, mask):
    w = _clusters()
    m = RULE_MASKS[mask]
    js, ts = _make_both(name, extra)
    assert ts.hierarchical == js.hierarchical
    assert ts.n_groups == js.n_groups
    if name.startswith("coalition"):
        jstate = jco.CoalitionState(
            center_idx=jnp.asarray(CENTERS, jnp.int32), round=jnp.int32(0))
        tstate = tco.CoalitionState(center_idx=torch.tensor(CENTERS),
                                    round=0)
    else:
        jstate = js.init_state(None, jnp.asarray(w))
        tstate = ts.init_state(torch.from_numpy(w))
    ref = js.round(jnp.asarray(w), jstate,
                   mask=None if m is None else jnp.asarray(m))
    got = ts.round(torch.from_numpy(w), tstate,
                   mask=None if m is None else torch.from_numpy(m))
    _close(got.theta.numpy(), ref.theta)
    np.testing.assert_array_equal(got.metrics.assignment.numpy(),
                                  np.asarray(ref.metrics.assignment))
    np.testing.assert_allclose(got.metrics.counts.numpy(),
                               np.asarray(ref.metrics.counts), rtol=0,
                               atol=1e-5)
    if name.startswith("coalition"):
        np.testing.assert_array_equal(got.state.center_idx.numpy(),
                                      np.asarray(ref.state.center_idx))
        _close(got.barycenters.numpy(), ref.barycenters)
        np.testing.assert_allclose(got.metrics.radius.numpy(),
                                   np.asarray(ref.metrics.radius),
                                   rtol=1e-5, atol=1e-5)
        if m is not None:                  # zero mass is never a medoid
            assert all(m[i] > 0 for i in got.state.center_idx.tolist())
    else:
        assert got.barycenters is None and ref.barycenters is None
        assert got.state == int(ref.state) == 1
        assert torch.equal(got.metrics.radius, torch.zeros(1))


@pytest.mark.parametrize("name,extra", RULES,
                         ids=[f"{n}-{'-'.join(e)}" for n, e in RULES])
def test_rule_all_ones_mask_is_the_unmasked_round(name, extra):
    """An all-ones mask reproduces mask=None bit for bit (the identity the
    substrate engine's ideal fleet relies on)."""
    w = torch.from_numpy(_clusters(seed=8))
    _, ts = _make_both(name, extra)
    state = (tco.CoalitionState(center_idx=torch.tensor(CENTERS), round=0)
             if name.startswith("coalition") else ts.init_state(w))
    a = ts.round(w, state)
    b = ts.round(w, state, mask=torch.ones(NC))
    assert torch.equal(a.theta, b.theta)
    assert torch.equal(a.metrics.assignment, b.metrics.assignment)
    assert torch.equal(a.metrics.counts, b.metrics.counts)
    assert torch.equal(a.metrics.radius, b.metrics.radius)


def test_topk_with_fractional_counts_matches_reference():
    """Masses that leave two coalitions' counts tied at a fraction: the
    lower index wins, as jax.lax.top_k breaks the tie."""
    w = _clusters(seed=9)
    m = np.array([1, 1, 0.5, 1, 1, 1, 0.5, 1, 0.5, 1, 0.5, 1], np.float32)
    js, ts = _make_both("coalition_topk", {"top_m": 1})
    jstate = jco.CoalitionState(center_idx=jnp.asarray(CENTERS, jnp.int32),
                                round=jnp.int32(0))
    tstate = tco.CoalitionState(center_idx=torch.tensor(CENTERS), round=0)
    ref = js.round(jnp.asarray(w), jstate, mask=jnp.asarray(m))
    got = ts.round(torch.from_numpy(w), tstate, mask=torch.from_numpy(m))
    counts = got.metrics.counts
    assert counts[0] == counts[1] > counts[2]       # a fractional tie
    _close(got.theta.numpy(), ref.theta)
    assert torch.equal(got.theta, got.barycenters[0])


@pytest.mark.parametrize("mask", [None, "binary", "stale"])
def test_flat_metrics_report_the_mass(mask):
    m = RULE_MASKS[mask]
    ts = tstr.make_strategy("fedavg", n_clients=NC, n_coalitions=3)
    w = torch.from_numpy(_clusters())
    got = ts.round(w, 0, mask=None if m is None else torch.from_numpy(m))
    want = float(NC) if m is None else float(np.sum(m, dtype=np.float32))
    assert got.metrics.counts.tolist() == pytest.approx([want, 0.0, 0.0])
    assert torch.equal(got.metrics.assignment,
                       torch.zeros(NC, dtype=torch.long))


def test_strategy_validation_matches_reference():
    for mod in (jstr, tstr):
        with pytest.raises(ValueError):
            mod.make_strategy("fedavg_trimmed", n_clients=4, trim=2)
        with pytest.raises(ValueError):
            mod.make_strategy("coalition_topk", n_clients=6,
                              n_coalitions=2, top_m=3)
        with pytest.raises(KeyError):
            mod.make_strategy("nope", n_clients=4)
    assert tstr.available_strategies() == jstr.available_strategies()
