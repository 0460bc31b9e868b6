"""The port's IoT substrate (``repro_torch.sim``) against ``repro.sim``.

The port samples its fleets from a torch generator, so its tables are its
own: they are checked for the reference's ranges and link ratios and for
determinism in the seed.  Everything else runs on the same inputs as the
reference: its device tables carried over with ``carry.fleet_from_jax``,
and its availability draws rebuilt from its key splits
(``repro/sim/availability.py``) and injected.  Masks must be equal; clock
and byte figures within rtol 1e-6, and exactly 0.0 on the ideal fleet.

The scenarios are numpy on both sides: ``quantity_rank``, ``couple`` and
every registered scenario on the reference's table (the port's
``make_fleet`` replaced by the carried table for the test) must equal the
reference exactly, permutation, ranks, index matrix and ``spearman``.
The cohort sampler must return the reference's ids from the reference's
Gumbel rows, and its hierarchical top-k (cells of 64) must equal flat
top-k.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro.data import partition as jpartition
from repro.data import synthetic
from repro.sim import scenarios as jscenarios
from repro_torch import carry
from repro_torch import sim as tsim
from repro_torch.sim import scenarios as tscenarios
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

N = 16
FLEETS = ("ideal", "uniform", "lognormal-edge", "cellular-flaky")
RTOL = 1e-6
MODEL_BYTES = 2_328_104        # the paper CNN in f32


def test_fleet_registry_matches_reference():
    assert tsim.available_fleets() == jsim.available_fleets()
    with pytest.raises(ValueError, match="cellular-flaky"):
        tsim.make_fleet("nope", 4)
    with pytest.raises(ValueError):
        tsim.make_fleet("uniform", 0)


@pytest.mark.parametrize("name", FLEETS)
def test_sampled_fleet_is_deterministic_in_the_seed(name):
    a = tsim.make_fleet(name, N, seed=3)
    b = tsim.make_fleet(name, N, seed=3)
    c = tsim.make_fleet(name, N, seed=4)
    for col in tsim.DeviceFleet._fields:
        x = getattr(a, col)
        assert x.dtype == np.float32 and x.shape == (N,)
        np.testing.assert_array_equal(x, getattr(b, col))
    if name != "ideal":
        assert not np.array_equal(a.compute_s, c.compute_s)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampled_fleets_keep_the_reference_ranges(seed):
    u = tsim.make_fleet("uniform", N, seed=seed)
    assert np.all((u.compute_s >= 0.5) & (u.compute_s <= 2.0))
    assert np.all((u.uplink_bps >= 1e6) & (u.uplink_bps <= 10e6))
    assert np.all((u.downlink_bps >= 5e6) & (u.downlink_bps <= 20e6))
    assert np.all(u.p_available == 1.0) and np.all(u.persistence == 0.0)
    e = tsim.make_fleet("lognormal-edge", N, seed=seed)
    np.testing.assert_array_equal(e.downlink_bps, 4.0 * e.uplink_bps)
    assert np.all((e.p_available >= 0.85) & (e.p_available <= 1.0))
    assert np.all(e.persistence == np.float32(0.3))
    assert np.all(e.compute_s > 0) and np.all(e.uplink_bps > 0)
    f = tsim.make_fleet("cellular-flaky", N, seed=seed)
    np.testing.assert_array_equal(f.downlink_bps, 8.0 * f.uplink_bps)
    assert np.all((f.p_available >= 0.4) & (f.p_available <= 0.9))
    assert np.all(f.persistence == 0.5)
    assert np.all(f.compute_s > 0) and np.all(f.uplink_bps > 0)


def test_lognormal_medians_are_the_reference_ones():
    """Over many devices the sampled medians approach the profiles'."""
    e = tsim.make_fleet("lognormal-edge", 4096, seed=0)
    f = tsim.make_fleet("cellular-flaky", 4096, seed=0)
    for got, want in ((e.compute_s, 1.0), (e.uplink_bps, 2e6),
                      (f.compute_s, 1.5), (f.uplink_bps, 2.5e5)):
        assert abs(np.median(got) / want - 1.0) < 0.1


@pytest.mark.parametrize("name", FLEETS)
def test_fleet_from_jax_carries_the_reference_table(name):
    ref = jsim.make_fleet(name, N, seed=5)
    got = carry.fleet_from_jax(ref)
    assert isinstance(got, tsim.DeviceFleet)
    for col in tsim.DeviceFleet._fields:
        x = getattr(got, col)
        assert isinstance(x, np.ndarray) and x.dtype == np.float32
        np.testing.assert_array_equal(x, np.asarray(getattr(ref, col)))


def _reference_chain(key, fleet, participation, rounds, device_time,
                     deadline):
    """The reference's masks, and its draws rebuilt from its key splits."""
    astate = jsim.init_availability(key, fleet, participation)
    k0 = jax.random.split(key)[1]
    online = np.asarray(jax.random.bernoulli(
        k0, jsim.effective_p(fleet, participation)))
    np.testing.assert_array_equal(online, np.asarray(astate.online))
    masks, stay, fresh = [], [], []
    for _ in range(rounds):
        _, k_stay, k_fresh = jax.random.split(astate.key, 3)
        stay.append(np.asarray(jax.random.bernoulli(k_stay,
                                                    fleet.persistence)))
        fresh.append(np.asarray(jax.random.bernoulli(
            k_fresh, jsim.effective_p(fleet, participation))))
        mask, astate = jsim.sample_mask(astate, fleet, participation,
                                        device_time=device_time,
                                        deadline=deadline)
        masks.append(np.asarray(mask))
    return online, np.stack(stay), np.stack(fresh), np.stack(masks)


@pytest.mark.parametrize("name,participation,deadline", [
    ("cellular-flaky", 1.0, float("inf")), ("cellular-flaky", 0.6, 30.0),
    ("lognormal-edge", 1.0, 8.0), ("uniform", 1.0, 3.0),
    ("ideal", 1.0, float("inf"))])
def test_sample_mask_matches_reference(name, participation, deadline):
    jfleet = jsim.make_fleet(name, N, seed=2)
    jtime = jsim.device_round_time(jfleet, MODEL_BYTES)
    online, stay, fresh, want = _reference_chain(
        jax.random.key(11), jfleet, participation, 6,
        jtime if np.isfinite(deadline) else None, deadline)
    fleet = carry.fleet_from_jax(jfleet)
    dev_time = tsim.device_round_time(fleet, MODEL_BYTES)
    state = tsim.init_availability(online)
    for r in range(len(want)):
        mask, state = tsim.sample_mask(
            state, torch.from_numpy(stay[r]), torch.from_numpy(fresh[r]),
            device_time=dev_time if np.isfinite(deadline) else None,
            deadline=deadline)
        assert mask.dtype == torch.bool
        np.testing.assert_array_equal(mask.numpy(), want[r])
    if name == "ideal":
        assert want.all()
    if name == "cellular-flaky":
        assert not want.all()


def test_draw_availability_is_seeded_and_ideal_is_always_online():
    fleet = tsim.make_fleet("cellular-flaky", N, seed=0)
    a = tsim.draw_availability(fleet, 1.0, 5, torch.Generator().manual_seed(1))
    b = tsim.draw_availability(fleet, 1.0, 5, torch.Generator().manual_seed(1))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a.stay.shape == a.fresh.shape == (4, N) and a.online.shape == (N,)
    ideal = tsim.draw_availability(tsim.make_fleet("ideal", N), 1.0, 5,
                                   torch.Generator().manual_seed(1))
    assert ideal.online.all() and ideal.fresh.all() and not ideal.stay.any()
    none = tsim.draw_availability(fleet, 0.0, 5,
                                  torch.Generator().manual_seed(1))
    assert not none.online.any() and not none.fresh.any()


def test_effective_p_matches_reference():
    jfleet = jsim.make_fleet("cellular-flaky", N, seed=1)
    fleet = carry.fleet_from_jax(jfleet)
    for part in (0.0, 0.5, 1.0, 1.7):
        np.testing.assert_array_equal(
            tsim.effective_p(fleet, part).numpy(),
            np.asarray(jsim.effective_p(jfleet, part)))


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0, 2.0])
def test_staleness_weights_match_reference(alpha):
    tau = np.arange(8, dtype=np.int32)
    got = tsim.staleness_weights(torch.from_numpy(tau), alpha)
    want = np.asarray(jsim.staleness_weights(jnp.asarray(tau), alpha))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    assert got[0].item() == 1.0 and got.dtype == torch.float32


@pytest.mark.parametrize("name", FLEETS)
def test_device_time_and_energy_match_reference(name):
    jfleet = jsim.make_fleet(name, N, seed=3)
    fleet = carry.fleet_from_jax(jfleet)
    for work in (1.0, 2.5):
        np.testing.assert_allclose(
            tsim.device_round_time(fleet, MODEL_BYTES, work).numpy(),
            np.asarray(jsim.device_round_time(jfleet, MODEL_BYTES, work)),
            rtol=RTOL, atol=0)
        np.testing.assert_allclose(
            tsim.device_event_energy(fleet, MODEL_BYTES, work,
                                     tx_power_w=1.5).numpy(),
            np.asarray(jsim.device_event_energy(jfleet, MODEL_BYTES, work,
                                                tx_power_w=1.5)),
            rtol=RTOL, atol=0)
    if name == "ideal":
        assert torch.equal(tsim.device_round_time(fleet, MODEL_BYTES),
                           torch.zeros(N))
        assert torch.equal(tsim.device_event_energy(fleet, MODEL_BYTES),
                           torch.zeros(N))


MASK_CASES = {
    "full": np.ones(N, bool),
    "partial": np.arange(N) % 3 != 0,
    "one": np.arange(N) == 5,
    "empty": np.zeros(N, bool),
}


@pytest.mark.parametrize("deadline", [float("inf"), 4.0])
@pytest.mark.parametrize("hierarchical", [False, True])
@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_round_stats_match_reference(case, hierarchical, deadline):
    mask = MASK_CASES[case]
    jfleet = jsim.make_fleet("lognormal-edge", N, seed=4)
    jtime = jsim.device_round_time(jfleet, MODEL_BYTES)
    want = jsim.round_stats(jnp.asarray(mask), jtime, MODEL_BYTES, 3,
                            hierarchical, deadline=deadline)
    got = tsim.round_stats(
        torch.from_numpy(mask),
        tsim.device_round_time(carry.fleet_from_jax(jfleet), MODEL_BYTES),
        MODEL_BYTES, 3, hierarchical, deadline=deadline)
    for g, w in zip(got, want):
        assert g.shape == () and g.dtype == torch.float32
        np.testing.assert_allclose(g.item(), float(w), rtol=RTOL, atol=0)


def test_round_stats_on_ideal_are_exact():
    fleet = tsim.make_fleet("ideal", 10)
    t = tsim.device_round_time(fleet, MODEL_BYTES)
    full = torch.ones(10, dtype=torch.bool)
    sim_t, wan, edge = tsim.round_stats(full, t, MODEL_BYTES, 3, False)
    assert sim_t.item() == 0.0 and edge.item() == 0.0
    assert wan.item() == 10 * 2 * MODEL_BYTES
    sim_t, wan, edge = tsim.round_stats(full, t, MODEL_BYTES, 3, True)
    assert sim_t.item() == 0.0
    assert wan.item() == 3 * 2 * MODEL_BYTES
    assert edge.item() == 10 * 2 * MODEL_BYTES


def _labels(n=600):
    return synthetic.digits(n, seed=0)[1]


@pytest.mark.parametrize("regime", ["quantity", "dirichlet", "shard"])
def test_quantity_rank_matches_reference(regime):
    idx = jpartition.partition(regime, _labels(), 10, seed=1)
    got = tsim.quantity_rank(idx)
    np.testing.assert_array_equal(got, jscenarios.quantity_rank(idx))
    assert sorted(got.tolist()) == list(range(10))


@pytest.mark.parametrize("rho", [0.0, 0.3, 0.7, 1.0])
def test_couple_matches_reference(rho):
    rng = np.random.default_rng(int(rho * 10))
    for n in (2, 7, 16):
        cap, shard = rng.permutation(n), rng.permutation(n)
        got = tscenarios.couple(cap, shard, rho)
        np.testing.assert_array_equal(got,
                                      jscenarios.couple(cap, shard, rho))
        assert sorted(got.tolist()) == list(range(n))


def test_scenario_registry_matches_reference():
    assert tsim.available_scenarios() == jsim.available_scenarios()
    with pytest.raises(ValueError, match="correlated-skew"):
        tsim.make_scenario("independent", _labels(), 4, rho=0.5)
    with pytest.raises(ValueError):
        tsim.make_scenario("correlated-skew", _labels(), 4, rho=1.5)


@pytest.mark.parametrize("name,regime,rho", [
    ("correlated-skew", "dirichlet", 1.0), ("correlated-skew", "shard", 0.5),
    ("correlated-quantity", "quantity", 1.0),
    ("correlated-quantity", "quantity", 0.4), ("independent", "iid", 0.0)])
def test_scenarios_match_reference_on_the_same_table(monkeypatch, name,
                                                     regime, rho):
    labels = _labels()
    want = jsim.make_scenario(name, labels, 10, fleet="cellular-flaky",
                              regime=regime, rho=rho, seed=2, sim_seed=3)
    monkeypatch.setattr(tscenarios, "make_fleet", lambda fleet, n, seed:
                        carry.fleet_from_jax(jsim.make_fleet(fleet, n,
                                                             seed=seed)))
    got = tsim.make_scenario(name, labels, 10, fleet="cellular-flaky",
                             regime=regime, rho=rho, seed=2, sim_seed=3)
    np.testing.assert_array_equal(got.index_matrix, want.index_matrix)
    assert got.metadata == want.metadata
    if rho == 1.0:
        assert got.metadata["spearman"] >= 0.9


def test_coupled_scenario_on_the_ports_table_ranks_its_own_fleet():
    """On a sampled profile the port's table sets the permutation: rho = 1
    still hands the weakest device the most skewed shard."""
    labels = _labels()
    scn = tsim.make_scenario("correlated-skew", labels, 10,
                             fleet="cellular-flaky", regime="dirichlet",
                             rho=1.0, seed=0, sim_seed=0)
    cap = tsim.capability_rank(scn.fleet)
    np.testing.assert_array_equal(cap, scn.metadata["capability_rank"])
    assert scn.metadata["spearman"] >= 0.9
    base = tsim.make_scenario("independent", labels, 10,
                              fleet="cellular-flaky", regime="dirichlet",
                              seed=0, sim_seed=0)
    perm = scn.metadata["permutation"]
    np.testing.assert_array_equal(scn.index_matrix,
                                  base.index_matrix[perm])


def _weights(n, seed=0):
    w = np.random.default_rng(seed).uniform(0.05, 1.0, n).astype(np.float32)
    w[::7] = 0.0                       # never sampled
    return w


@pytest.mark.parametrize("n,c,cell", [(1000, 8, 64), (1000, 8, 4096),
                                      (4097, 16, 64), (300, 40, 32)])
def test_sample_cohort_matches_reference(n, c, cell):
    w = _weights(n, n)
    key = jax.random.key(n + c)
    gumbel = np.array(jax.random.gumbel(key, (n,), jnp.float32))
    want = np.asarray(jsim.sample_cohort(key, jnp.asarray(w), c,
                                         cell_size=cell))
    got = tsim.sample_cohort(torch.from_numpy(w), c, gumbel, cell_size=cell)
    assert got.dtype == torch.long and got.shape == (c,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got.tolist())) == c and np.all(w[got.numpy()] > 0)
    flat = tsim.sample_cohort(torch.from_numpy(w), c, gumbel, cell_size=n)
    assert torch.equal(flat, got)


def test_sample_cohorts_matches_reference_row_by_row():
    n, c, steps = 2000, 10, 4
    w = _weights(n, 1)
    key = jax.random.key(3)
    rows = np.stack([np.array(jax.random.gumbel(
        jax.random.fold_in(key, r), (n,), jnp.float32)) for r in range(steps)])
    want = np.asarray(jsim.sample_cohorts(key, jnp.asarray(w), steps, c,
                                          cell_size=64))
    got = tsim.sample_cohorts(torch.from_numpy(w), steps, c, gumbel=rows,
                              cell_size=64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tsim.COHORT_STREAM == jsim.COHORT_STREAM
    assert tsim.DEFAULT_CELL == 4096


def test_hierarchical_cohorts_equal_flat_top_k():
    n, c = 5000, 12
    w = torch.from_numpy(_weights(n, 2))
    hier = tsim.sample_cohorts(w, 3, c, cell_size=64,
                               generator=torch.Generator().manual_seed(1))
    flat = tsim.sample_cohorts(w, 3, c, cell_size=n,
                               generator=torch.Generator().manual_seed(1))
    assert torch.equal(hier, flat)
    assert not torch.equal(hier[0], hier[1])    # rows are independent draws
    with pytest.raises(ValueError):
        tsim.sample_cohort(w, 0, torch.zeros(n))
    with pytest.raises(ValueError):
        tsim.sample_cohort(w, n + 1, torch.zeros(n))
    with pytest.raises(ValueError):
        tsim.sample_cohorts(w, 2, c)
