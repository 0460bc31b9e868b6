"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card.  The module
imports neither JAX nor the reference package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)  Kernel and plain
version compute in f32 from the same inputs (bf16 W is upcast on load by
both), so both dtypes are held to 5e-6 of the max.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_round as tfr
from repro_torch.kernels import ref as tref

TOL = 5e-6
SHAPES = [(10, 3, 1000, "float32"), (7, 2, 4097, "float32"),
          (16, 4, 8192, "float32"), (10, 3, 5000, "bfloat16"),
          (10, 3, 582_026, "float32"), (64, 8, 100_003, "float32")]


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
