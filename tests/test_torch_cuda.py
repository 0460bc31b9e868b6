"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card.  The module
imports neither JAX nor the reference package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)  Kernel and plain
version compute in f32 from the same inputs (bf16 W is upcast on load by
both), so both dtypes are held to 5e-6 of the max.  The distance and
segment-sum kernels run at the main path's shape, at the sketch widths
D = S in {64, 256, 1024}, at N = 64, K = 8 and in bf16, and with W and the
points in different dtypes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_round as tfr
from repro_torch.kernels import pairwise_dist as tpd
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_mean as tsm

TOL = 5e-6
SHAPES = [(10, 3, 1000, "float32"), (7, 2, 4097, "float32"),
          (16, 4, 8192, "float32"), (10, 3, 5000, "bfloat16"),
          (10, 3, 582_026, "float32"), (64, 8, 100_003, "float32")]
#: (N, K, D, W dtype, points dtype) of the distance and segment-sum kernels
DIST_SHAPES = [(10, 3, 582_026, "float32", "float32"),
               (10, 3, 64, "float32", "float32"),
               (10, 3, 256, "float32", "float32"),
               (10, 3, 1024, "float32", "float32"),
               (64, 8, 100_003, "float32", "float32"),
               (16, 4, 70_001, "bfloat16", "bfloat16"),
               (7, 2, 4097, "float32", "bfloat16"),
               (32, 20, 5001, "float32", "float32"),
               (1, 1, 3000, "bfloat16", "float32")]


def _inputs(n, k, d, dtype, seed=0):
    """W (N, D) on the card, the (K, N) center one-hot and a normalised
    (K, N) aggregation matrix, from numpy at ``seed``."""
    rng = np.random.default_rng(seed + n * d)
    w = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    conehot = np.eye(n, dtype=np.float32)[rng.permutation(n)[:k]]
    m = np.eye(k, dtype=np.float32)[rng.integers(0, k, n)].T
    m = m / np.maximum(m.sum(1, keepdims=True), 1.0)
    return (w.to(getattr(torch, dtype)).cuda(),
            torch.from_numpy(conehot).cuda(),
            torch.from_numpy(np.ascontiguousarray(m, np.float32)).cuda())


def _close(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    err = float((got - want).abs().max())
    assert err <= TOL * (float(want.abs().max()) + 1e-6), err


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d,dtype", SHAPES)
def test_cuda_kernels_match_plain_versions(n, k, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, conehot, m = _inputs(n, k, d, dtype)
    before = dict(tfr.LAUNCHES)
    got = tfr.center_sq_dists(w, conehot)
    stats = tfr.fused_coalition_stats(w, m)
    torch.cuda.synchronize()
    assert tfr.LAUNCHES["center_sq_dists"] == before["center_sq_dists"] + 1
    assert (tfr.LAUNCHES["fused_coalition_stats"]
            == before["fused_coalition_stats"] + 1)
    _close(got, tref.center_sq_dists(w, conehot))
    for g, r in zip(stats, tref.fused_coalition_stats(w, m)):
        _close(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d,wdt,pdt", DIST_SHAPES)
def test_cuda_distance_kernels_match_plain_versions(n, k, d, wdt, pdt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, _, m = _inputs(n, k, d, wdt)
    rng = np.random.default_rng(d + 1)
    p = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    p = p.to(getattr(torch, pdt)).cuda()
    before = dict(tpd.LAUNCHES), dict(tsm.LAUNCHES)
    to_points = tpd.sq_dists_to_points(w, p)
    pairwise = tpd.pairwise_sq_dists(w)
    sums = tsm.segment_sum(m, w)
    torch.cuda.synchronize()
    assert tpd.LAUNCHES["sq_dists_to_points"] == (
        before[0]["sq_dists_to_points"] + 1)
    assert tpd.LAUNCHES["pairwise_sq_dists"] == (
        before[0]["pairwise_sq_dists"] + 1)
    assert tsm.LAUNCHES["segment_sum"] == before[1]["segment_sum"] + 1
    _close(to_points, tref.sq_dists_to_points(w, p))
    _close(pairwise, tref.pairwise_sq_dists(w))
    _close(sums, tref.segment_sum(m, w))
    assert torch.equal(pairwise, pairwise.T)
    assert torch.all(torch.diagonal(pairwise) == 0)
    assert torch.all(to_points >= 0) and torch.all(pairwise >= 0)
