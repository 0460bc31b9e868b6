"""The port's sketched geometry, coalition_topk and sketch CLI against the
reference package.

* Sketch maps.  The reference's map is read off by sketching an identity
  (rproj gives R/√S, countsketch the sign of column j at [j, j mod S]) and
  injected into the port's sketcher; ``sketch_matrix`` then agrees with the
  reference's at rtol 2e-5, with atol 2e-5 of the max for entries that
  cancel to near 0 (the two matmuls sum in different orders).  The port's
  own hashed map is held to the reference's ``TestSketchers`` properties
  (tests/test_sketch.py): determinism, chunking invariance, offset
  partials, row equivariance, JL error and the registry.
* Sketched rounds, with the injected maps, against
  ``repro.core.coalitions.run_round`` on well-separated clusters, for the
  backend pairs stream↔xla, dot↔dot and cuda↔pallas: assignment, counts
  and new centers equal; θ and barycenters within 1e-5 of their max;
  ``med_d2`` within 5e-6 of its max.  W passes: 2 per sketched round, 1
  from a given sketch.
* ``coalition_topk`` against the reference's strategy, tied counts included.
* The CLI's consumer checks exit as the reference's do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coalitions as jco
from repro.core import sketch as jsk
from repro.core import strategies as jstrat
from repro.launch import train as jtrain
from repro_torch.core import coalitions as tco
from repro_torch.core import fused as tfz
from repro_torch.core import instrument
from repro_torch.core import sketch as tsk
from repro_torch.core import strategies as tstrat
from repro_torch.launch import train as ttrain
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

PAIRS = [("stream", "xla"), ("dot", "dot"), ("cuda", "pallas")]
NAMES = ["rproj", "countsketch"]


def _w(n=12, d=2048, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32))


def _injected(name, dim, d, seed=0):
    """The reference's sketcher and the port's, with the reference's map."""
    ref = jsk.make_sketcher(name, dim=dim, seed=seed)
    m = np.asarray(jsk.sketch_block(ref, jnp.eye(d, dtype=jnp.float32)))
    if name == "rproj":
        mat = np.round(m * np.sqrt(dim)).astype(np.float32)
        assert set(np.unique(mat)) == {-1.0, 1.0}
        got = tsk.RProjSketcher(name=name, dim=dim, seed=seed,
                                matrix=torch.from_numpy(mat))
    else:
        signs = m[np.arange(d), np.arange(d) % dim]
        assert set(np.unique(signs)) == {-1.0, 1.0}
        got = tsk.CountSketcher(name=name, dim=dim, seed=seed,
                                signs=torch.from_numpy(signs))
    return ref, got


def _close_sketch(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())


# -- sketch maps ---------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("d,dim", [(1000, 64), (3001, 256)])
def test_injected_map_matches_reference(name, d, dim):
    ref, got = _injected(name, dim, d)
    w = _w(6, d, seed=d)
    _close_sketch(tsk.sketch_matrix(got, w),
                  jsk.sketch_matrix(ref, jnp.asarray(w.numpy())))
    # chunked, with a narrower last chunk (1000 does not divide 3001)
    _close_sketch(tsk.sketch_block(got, w, chunk=1000),
                  jsk.sketch_block(ref, jnp.asarray(w.numpy()), chunk=1000))


class TestSketchers:
    """The port's own map, mirroring tests/test_sketch.py::TestSketchers."""

    @pytest.mark.parametrize("name", NAMES)
    def test_seeded_determinism(self, name):
        w = _w()
        a = tsk.sketch_matrix(tsk.make_sketcher(name, dim=64), w)
        b = tsk.sketch_matrix(tsk.make_sketcher(name, dim=64), w)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        c = tsk.sketch_matrix(tsk.make_sketcher(name, dim=64, seed=1), w)
        assert not np.array_equal(a.numpy(), c.numpy())

    @pytest.mark.parametrize("name", NAMES)
    def test_chunking_invariance(self, name):
        w = _w()
        sk = tsk.make_sketcher(name, dim=64)
        full = tsk.sketch_block(sk, w, chunk=4096)
        for chunk in (128, 512, 1000):
            np.testing.assert_allclose(tsk.sketch_block(sk, w, chunk=chunk),
                                       full, rtol=2e-5, atol=1e-5)

    @pytest.mark.parametrize("name", NAMES)
    def test_partial_offsets_sum_to_full(self, name):
        w = _w()
        sk = tsk.make_sketcher(name, dim=64)
        full = tsk.sketch_block(sk, w, chunk=4096)
        parts = sum(tsk.sketch_block(sk, w[:, o:o + 512], col_offset=o,
                                     chunk=4096)
                    for o in range(0, 2048, 512))
        np.testing.assert_allclose(parts, full, rtol=2e-5, atol=1e-5)

    @pytest.mark.parametrize("name", NAMES)
    def test_row_permutation_equivariance(self, name):
        w = _w()
        sk = tsk.make_sketcher(name, dim=32)
        perm = torch.from_numpy(np.random.default_rng(9).permutation(12))
        np.testing.assert_array_equal(tsk.sketch_matrix(sk, w[perm]).numpy(),
                                      tsk.sketch_matrix(sk, w)[perm].numpy())

    def test_rproj_preserves_distances(self):
        """JL: pairwise sq-dists survive S=256 to ~20% relative error."""
        w = _w(n=8, d=4096, seed=3)
        s = tsk.sketch_matrix(tsk.make_sketcher("rproj", dim=256), w)
        d_full = torch.sum((w[:, None] - w[None, :]) ** 2, dim=-1).numpy()
        d_sk = torch.sum((s[:, None] - s[None, :]) ** 2, dim=-1).numpy()
        iu = np.triu_indices(8, k=1)
        rel = np.abs(d_sk[iu] - d_full[iu]) / d_full[iu]
        assert rel.max() < 0.35 and rel.mean() < 0.15

    @pytest.mark.parametrize("name", NAMES)
    def test_map_is_balanced_rademacher(self, name):
        """The hashed signs are ±1 and balanced (the map read off an
        identity: R/√S for rproj, one signed bucket per column)."""
        d, dim = 4096, 64
        m = tsk.sketch_block(tsk.make_sketcher(name, dim=dim),
                             torch.eye(d)).numpy()
        if name == "rproj":
            signs = m * np.sqrt(dim)
        else:
            assert np.count_nonzero(m) == d
            signs = m[np.arange(d), np.arange(d) % dim]
        np.testing.assert_allclose(np.abs(signs), 1.0, rtol=1e-6)
        assert abs(signs.mean()) < 0.05

    def test_identity_is_w(self):
        w = _w()
        sk = tsk.make_sketcher("identity")
        assert sk.is_identity
        assert tsk.sketch_matrix(sk, w) is w

    def test_registry(self):
        assert tsk.available_sketchers() == ["countsketch", "identity",
                                             "rproj"]
        assert tsk.make_sketcher("rproj").dim == 256
        with pytest.raises(ValueError, match="unknown sketch"):
            tsk.make_sketcher("nope")


# -- sketched rounds -----------------------------------------------------------------

def _clusters(n_per=4, d=2048, sep=8.0, seed=2):
    """Three well-separated clusters, one center seeded in each."""
    rng = np.random.default_rng(seed)
    owner = np.repeat(np.arange(3), n_per)
    w = ((owner[:, None] - 1.0) * sep
         + 0.5 * rng.standard_normal((3 * n_per, d))).astype(np.float32)
    return w, np.array([0, n_per, 2 * n_per])


def _assert_round_match(ref, got):
    for field in ("assignment", "new_center_idx"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(ref.counts),
                               rtol=1e-6)
    for field, tol in (("barycenters", 1e-5), ("theta", 1e-5),
                       ("med_d2", 5e-6)):
        want = np.asarray(getattr(ref, field), np.float64)
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(
            getattr(got, field).numpy().astype(np.float64) / scale,
            want / scale, rtol=0, atol=tol, err_msg=field)


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
@pytest.mark.parametrize("name", NAMES)
def test_sketched_round_matches_reference(name, backend, ref_backend):
    w, centers = _clusters()
    ref_sk, got_sk = _injected(name, 64, w.shape[1])
    jstate = jco.CoalitionState(center_idx=jnp.asarray(centers, jnp.int32),
                                round=jnp.int32(0))
    ref = jco.run_round(jnp.asarray(w), jstate, backend=ref_backend,
                        sketcher=ref_sk)
    tstate = tco.CoalitionState(center_idx=torch.from_numpy(centers),
                                round=0)
    got = tco.run_round(torch.from_numpy(w), tstate, backend=backend,
                        sketcher=got_sk)
    _assert_round_match(ref, got)
    # fused=False still takes the sketched (fused) entry point
    composed = tco.run_round(torch.from_numpy(w), tstate, backend=backend,
                             sketcher=got_sk, fused=False)
    np.testing.assert_array_equal(composed.theta.numpy(), got.theta.numpy())


@pytest.mark.parametrize("backend", ["stream", "dot", "cuda"])
def test_identity_sketch_is_the_exact_round(backend):
    w, centers = _clusters(d=257)
    state = tco.CoalitionState(center_idx=torch.from_numpy(centers), round=0)
    plain = tco.run_round(torch.from_numpy(w), state, backend=backend)
    ident = tco.run_round(torch.from_numpy(w), state, backend=backend,
                          sketcher=tsk.make_sketcher("identity"))
    for a, b in zip(plain, ident):
        if isinstance(a, tco.CoalitionState):
            a, b = a.center_idx, b.center_idx
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("backend", ["stream", "dot", "cuda"])
def test_sketched_round_w_passes(backend):
    """A sketched round sweeps W twice (the sketch, the segment sum); with
    the sketch in hand, once."""
    w, centers = _clusters(d=7_001)
    w, ci = torch.from_numpy(w), torch.from_numpy(centers)
    state = tco.CoalitionState(center_idx=ci, round=0)
    sk = tsk.make_sketcher("rproj", dim=64)
    with instrument.count_w_passes() as passes:
        tco.run_round(w, state, backend=backend, sketcher=sk)
    assert passes() == 2
    s_w = tsk.sketch_matrix(sk, w)
    with instrument.count_w_passes() as passes:
        tfz.sketched_fused_round(tfz.bk.get_backend(backend), w, s_w, ci)
    assert passes() == 1


def test_suspend_w_passes_nests():
    with instrument.count_w_passes() as passes:
        instrument.count_w_pass()
        with instrument.suspend_w_passes():
            instrument.count_w_pass(5)
        instrument.count_w_pass()
    assert passes() == 2


# -- coalition_topk ------------------------------------------------------------------

def _topk_both(w, centers, top_m, **extra):
    ref = jstrat.make_strategy("coalition_topk", n_clients=w.shape[0],
                               n_coalitions=len(centers), top_m=top_m)
    got = tstrat.make_strategy("coalition_topk", n_clients=w.shape[0],
                               n_coalitions=len(centers), top_m=top_m,
                               **extra)
    jstate = jco.CoalitionState(center_idx=jnp.asarray(centers, jnp.int32),
                                round=jnp.int32(0))
    tstate = tco.CoalitionState(center_idx=torch.from_numpy(centers),
                                round=0)
    return (ref.round(jnp.asarray(w), jstate),
            got.round(torch.from_numpy(w), tstate))


def _assert_topk_match(ref, got):
    np.testing.assert_array_equal(got.metrics.assignment.numpy(),
                                  np.asarray(ref.metrics.assignment))
    np.testing.assert_array_equal(got.metrics.counts.numpy(),
                                  np.asarray(ref.metrics.counts))
    np.testing.assert_array_equal(got.state.center_idx.numpy(),
                                  np.asarray(ref.state.center_idx))
    want = np.asarray(ref.theta, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.theta.numpy() / scale, want / scale,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("top_m", [1, 2, 3])
def test_topk_matches_reference(top_m):
    """Clusters of 5, 4 and 3 clients: distinct counts."""
    rng = np.random.default_rng(11)
    owner = np.repeat(np.arange(3), [5, 4, 3])
    w = ((owner[:, None] - 1.0) * 6.0
         + 0.5 * rng.standard_normal((12, 3000))).astype(np.float32)
    ref, got = _topk_both(w, np.array([0, 5, 9]), top_m)
    _assert_topk_match(ref, got)


@pytest.mark.parametrize("centers", [[0, 4, 7], [7, 4, 0], [4, 0, 7]])
def test_topk_tied_counts_match_reference(centers):
    """10 clients in coalitions of 4, 3 and 3 (in some order of the
    coalition ids): top_m = 2 keeps the 4 and the lower-index 3, as
    jax.lax.top_k breaks the tie."""
    rng = np.random.default_rng(12)
    owner = np.repeat(np.arange(3), [4, 3, 3])
    w = ((owner[:, None] - 1.0) * 6.0
         + 0.5 * rng.standard_normal((10, 2000))).astype(np.float32)
    ref, got = _topk_both(w, np.array(centers), 2)
    assert sorted(got.metrics.counts.tolist()) == [3.0, 3.0, 4.0]
    _assert_topk_match(ref, got)


def test_topk_sketched_matches_reference():
    w, centers = _clusters()
    ref_sk, got_sk = _injected("countsketch", 64, w.shape[1])
    ref = jstrat.make_strategy("coalition_topk", n_clients=12,
                               n_coalitions=3, sketch=ref_sk)
    got = tstrat.make_strategy("coalition_topk", n_clients=12,
                               n_coalitions=3, sketch=got_sk, backend="cuda")
    assert got.top_m == ref.top_m == 2
    r = ref.round(jnp.asarray(w), jco.CoalitionState(
        center_idx=jnp.asarray(centers, jnp.int32), round=jnp.int32(0)))
    g = got.round(torch.from_numpy(w), tco.CoalitionState(
        center_idx=torch.from_numpy(centers), round=0))
    _assert_topk_match(r, g)


@pytest.mark.parametrize("backend", ["stream", "dot", "cuda"])
def test_strategy_round_is_the_fused_round(backend):
    """The coalition strategy runs the two-pass fused round (2 W sweeps) and
    gives the composed round's assignment and θ on the same backend."""
    w, centers = _clusters(d=3001)
    w = torch.from_numpy(w)
    state = tco.CoalitionState(center_idx=torch.from_numpy(centers), round=0)
    strat = tstrat.make_strategy("coalition", n_clients=12, n_coalitions=3,
                                 backend=backend)
    with instrument.count_w_passes() as passes:
        got = strat.round(w, state)
    assert passes() == 2
    want = tco.run_round(w, state, backend=backend, fused=False)
    np.testing.assert_array_equal(got.metrics.assignment.numpy(),
                                  want.assignment.numpy())
    np.testing.assert_allclose(got.theta.numpy(), want.theta.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_topk_validates_top_m():
    with pytest.raises(ValueError, match="top_m"):
        tstrat.make_strategy("coalition_topk", n_clients=4, n_coalitions=2,
                             top_m=3)


# -- CLI -----------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--sketch-dim", "64"],
    ["--method", "coalition", "--top-m", "2"],
    ["--method", "coalition", "--sketch", "rproj", "--top-m", "1"],
])
def test_cli_consumer_checks_exit_as_the_reference(argv):
    with pytest.raises(SystemExit) as want:
        jtrain._strategy_extras(jtrain.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as got:
        ttrain.main(["--device", "cpu", *argv])
    assert str(got.value) == str(want.value)


def test_cli_summary_reports_the_sketch(capsys):
    out = ttrain.main(["--device", "cpu", "--method", "coalition_topk",
                       "--sketch", "countsketch", "--sketch-dim", "32",
                       "--regime", "shard", "--rounds", "1", "--clients", "4",
                       "--coalitions", "2", "--local-epochs", "1",
                       "--n-train", "200", "--n-test", "100"])
    assert out["sketch"] == "countsketch"
    assert out["strategy_extras"] == {"sketch": "countsketch",
                                      "sketch_dim": 32}
    assert '"sketch": "countsketch"' in capsys.readouterr().out
    assert len(out["test_acc"]) == 1 and np.isfinite(out["test_acc"][0])
