"""The port's coalition round against ``repro.core.coalitions.run_round``.

The cases of tests/test_fused_round.py (uniform, client weights, masked,
empty coalition, zero-mass medoid) run through both packages on the same
numpy inputs and the same initial centers, against the reference's exact
streaming backend (``xla``).  Assignments and centers must be exactly equal
(the inputs keep distances well apart); barycenters and θ agree within 1e-5
of their max.  The squared distances — ``med_d2`` and the squared radius,
the mean of a coalition's ``med_d2`` — agree within 1e-5 of the magnitude
their form rounds against: the largest distance for the diff-form backends
(``stream``, ``cuda``), the largest ‖w_i‖² for the Gram form (``dot``),
whose cancellation leaves errors of that order (tests/test_fused_round.py
holds ``dot`` to no distance tolerance at all).  Every port backend runs
fused and composed, against the reference's exact backend's path of the
same kind; the composed ``cuda`` round (the distance and segment-sum
kernels' plain versions here) is also held to the reference's composed
``pallas`` round (its Pallas kernels in interpret mode), and the composed
``dot`` round to the reference's composed ``dot`` round.  The W-pass count
is 2 fused and 3 composed, on every backend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import barycenter as jbary
from repro.core import coalitions as jco
from repro_torch.core import barycenter as tbary
from repro_torch.core import coalitions as tco
from repro_torch.core import instrument
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

CASES = [("stream", True), ("dot", True), ("cuda", True), ("stream", False),
         ("dot", False), ("cuda", False)]
TOL = 1e-5


def _rand_w(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _run_both(w, center_idx, backend, fused, client_weights=None,
              ref_backend="xla"):
    jstate = jco.CoalitionState(center_idx=jnp.asarray(center_idx, jnp.int32),
                                round=jnp.int32(0))
    ref = jco.run_round(jnp.asarray(w), jstate, fused=fused,
                        backend=ref_backend,
                        client_weights=None if client_weights is None
                        else jnp.asarray(client_weights))
    tstate = tco.CoalitionState(center_idx=torch.tensor(center_idx),
                                round=0)
    got = tco.run_round(torch.from_numpy(w), tstate, backend=backend,
                        fused=fused,
                        client_weights=None if client_weights is None
                        else torch.from_numpy(client_weights))
    return ref, got


def _assert_match(ref, got, w, backend):
    for field in ("assignment", "new_center_idx"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(ref.counts),
                               rtol=1e-6)
    for field in ("barycenters", "theta"):
        want = np.asarray(getattr(ref, field), np.float64)
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(getattr(got, field).numpy() / scale,
                                   want / scale, rtol=0, atol=TOL,
                                   err_msg=field)
    med_d2 = np.asarray(ref.med_d2, np.float64)
    scale = (np.max(np.sum(np.asarray(w, np.float64) ** 2, axis=1))
             if backend == "dot" else med_d2.max()) + 1e-12
    for field, want in (("med_d2", med_d2),
                        ("radius", np.asarray(ref.radius, np.float64) ** 2)):
        val = getattr(got, field).numpy().astype(np.float64)
        if field == "radius":
            val = val ** 2
        np.testing.assert_allclose(val / scale, want / scale, rtol=0,
                                   atol=TOL, err_msg=field)


def _centers(w, k, seed):
    """The reference's Step I, and the port's on the same permutation."""
    key = jax.random.key(seed)
    ref = np.asarray(jco.init_centers(key, jnp.asarray(w), k).center_idx)
    perm = np.array(jax.random.permutation(key, w.shape[0]))
    got = tco.init_centers(torch.from_numpy(w), k, perm=torch.from_numpy(perm))
    np.testing.assert_array_equal(got.center_idx.numpy(), ref)
    return ref


@pytest.mark.parametrize("backend,fused", CASES)
def test_uniform(backend, fused):
    w = _rand_w(10, 70_001, seed=1)
    ref, got = _run_both(w, _centers(w, 3, 0), backend, fused)
    _assert_match(ref, got, w, backend)


@pytest.mark.parametrize("backend,fused", CASES)
def test_client_weights(backend, fused):
    w = _rand_w(8, 5_000, seed=2)
    cw = np.random.default_rng(3).random(8).astype(np.float32) + 0.25
    ref, got = _run_both(w, _centers(w, 3, 1), backend, fused, cw)
    _assert_match(ref, got, w, backend)


@pytest.mark.parametrize("backend,fused", CASES)
def test_masked(backend, fused):
    """Absent clients carry zero mass and are not electable medoids.

    Three clusters of four clients, one center and one absent client in
    each: every coalition keeps three present members, so no medoid
    election is an exact tie (a coalition of two equal-mass members is
    equidistant from its barycenter, and rounding alone would pick the
    medoid).
    """
    rng = np.random.default_rng(4)
    w = (np.repeat(3.0 * rng.standard_normal((3, 3_001)), 4, axis=0)
         + rng.standard_normal((12, 3_001))).astype(np.float32)
    mask = np.array([1, 0, 1, 1] * 3, np.float32)
    ref, got = _run_both(w, np.array([0, 4, 8]), backend, fused, mask)
    _assert_match(ref, got, w, backend)
    for j, c in enumerate(got.new_center_idx.tolist()):
        if float(got.counts[j]) > 0:
            assert mask[c] > 0, "zero-mass client elected center"


@pytest.mark.parametrize("backend,fused", CASES)
def test_empty_coalition(backend, fused):
    """A coalition with zero mass keeps its previous center's weights."""
    rng = np.random.default_rng(5)
    w = np.concatenate([5 + 0.1 * rng.standard_normal((5, 300)),
                        -5 + 0.1 * rng.standard_normal((5, 300))]
                       ).astype(np.float32)
    cw = np.r_[np.ones(5), np.zeros(5)].astype(np.float32)
    ref, got = _run_both(w, np.array([0, 5]), backend, fused, cw)
    _assert_match(ref, got, w, backend)
    assert float(got.counts[1]) == 0.0
    np.testing.assert_allclose(got.barycenters[1].numpy(), w[5], rtol=1e-5)


def test_zero_mass_client_not_elected():
    w = np.stack([np.zeros(50), np.ones(50), -np.ones(50),
                  10 * np.ones(50)]).astype(np.float32)
    a = np.array([0, 0, 0, 1])
    cw = np.array([0.0, 1.0, 1.0, 1.0], np.float32)
    b, _ = tbary.barycenters(torch.from_numpy(w), torch.from_numpy(a), 2,
                             client_weights=torch.from_numpy(cw))
    got = tbary.medoids(torch.from_numpy(w), b, torch.from_numpy(a),
                        client_weights=torch.from_numpy(cw))
    jb, _ = jbary.barycenters(jnp.asarray(w), jnp.asarray(a), 2,
                              client_weights=jnp.asarray(cw))
    want = jbary.medoids(jnp.asarray(w), jb, jnp.asarray(a),
                         client_weights=jnp.asarray(cw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0]) in (1, 2)
    unweighted = tbary.medoids(torch.from_numpy(w), b, torch.from_numpy(a))
    assert int(unweighted[0]) == 0


def test_all_zero_mass_falls_back_to_global_argmin():
    w = _rand_w(6, 40, seed=8)
    a = np.array([0, 0, 0, 1, 1, 1])
    cw = np.array([1, 1, 1, 0, 0, 0], np.float32)
    fallback = w[[0, 3]]
    b, _ = tbary.barycenters(torch.from_numpy(w), torch.from_numpy(a), 2,
                             client_weights=torch.from_numpy(cw),
                             fallback=torch.from_numpy(fallback))
    got = tbary.medoids(torch.from_numpy(w), b, torch.from_numpy(a),
                        client_weights=torch.from_numpy(cw))
    jb, _ = jbary.barycenters(jnp.asarray(w), jnp.asarray(a), 2,
                              client_weights=jnp.asarray(cw),
                              fallback=jnp.asarray(fallback))
    want = jbary.medoids(jnp.asarray(w), jb, jnp.asarray(a),
                         client_weights=jnp.asarray(cw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_w_pass_counts():
    """Two sweeps over W fused, on every backend; three composed."""
    w = torch.from_numpy(_rand_w(10, 7_001, seed=7))
    state = tco.init_centers(w, 3, perm=torch.arange(10))
    for backend in ("stream", "dot", "cuda"):
        with instrument.count_w_passes() as passes:
            tco.run_round(w, state, backend=backend, fused=True)
        assert passes() == 2, backend
        with instrument.count_w_passes() as passes:
            tco.run_round(w, state, backend=backend, fused=False)
        assert passes() == 3, backend


def _case(name):
    """(w, centers, client weights) of the named case above."""
    rng = np.random.default_rng(4)
    if name == "uniform":
        w = _rand_w(10, 70_001, seed=1)
        return w, _centers(w, 3, 0), None
    if name == "client_weights":
        w = _rand_w(8, 5_000, seed=2)
        cw = np.random.default_rng(3).random(8).astype(np.float32) + 0.25
        return w, _centers(w, 3, 1), cw
    if name == "masked":
        w = (np.repeat(3.0 * rng.standard_normal((3, 3_001)), 4, axis=0)
             + rng.standard_normal((12, 3_001))).astype(np.float32)
        return w, np.array([0, 4, 8]), np.array([1, 0, 1, 1] * 3, np.float32)
    rng = np.random.default_rng(5)
    w = np.concatenate([5 + 0.1 * rng.standard_normal((5, 300)),
                        -5 + 0.1 * rng.standard_normal((5, 300))]
                       ).astype(np.float32)
    return w, np.array([0, 5]), np.r_[np.ones(5), np.zeros(5)].astype(
        np.float32)


@pytest.mark.parametrize("name,backend,ref_backend", [
    ("uniform", "cuda", "pallas"), ("client_weights", "cuda", "pallas"),
    ("masked", "cuda", "pallas"), ("empty", "cuda", "pallas"),
    ("client_weights", "dot", "dot"), ("masked", "dot", "dot"),
    ("empty", "dot", "dot")])
def test_composed_matches_paired_reference_backend(name, backend,
                                                   ref_backend):
    """The composed round against the reference's composed round on the
    paired backend: cuda (sq_dists_to_points twice, segment_sum once)
    against the Pallas kernels, dot against dot.  ``uniform`` has a
    two-member coalition ({6, 8}), whose members are exactly equidistant
    from their barycenter: its medoid is decided by rounding, which the
    Gram form's cancellation settles differently in the reference's own dot
    and xla rounds, so that case is held in the diff forms only."""
    w, centers, cw = _case(name)
    ref, got = _run_both(w, centers, backend, False, cw,
                         ref_backend=ref_backend)
    _assert_match(ref, got, w, backend)
