"""The port's kernels against the reference's.

On the CPU the port runs each kernel's plain PyTorch version; they are held
to the reference's Pallas kernels (interpret mode, as tests/test_kernels.py
runs them) and to ``repro.kernels.ref`` on the same numpy inputs, at the
shapes and with the bounds of tests/test_kernels.py: 5e-6 of the max for
f32, 5e-3 for bf16 (pairwise), rtol 1e-5 and atol 1e-4 for segment_sum.
The CUDA kernels themselves are held to the plain versions by
tests/test_torch_cuda.py, which runs on a card and skips without one.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import distance as jdist
from repro.kernels import fused_round as jfr
from repro.kernels import pairwise_dist as jpd
from repro.kernels import ref as jref
from repro.kernels import segment_mean as jsm
from repro_torch.core import distance as tdist
from repro_torch.kernels import build, ops
from repro_torch.kernels import conv_pool as tcp
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_round as tfr
from repro_torch.kernels import pairwise_dist as tpd
from repro_torch.kernels import segment_mean as tsm
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent
TOL = {"float32": 5e-6, "bfloat16": 5e-3}
SWEEP = [(10, 3, 1000, "float32"), (7, 2, 4097, "float32"),
         (16, 4, 8192, "float32"), (10, 3, 5000, "bfloat16")]


def _inputs(n, k, d, dtype, seed=0):
    """W (N, D) as numpy (f32, or bf16 values held in f32), the (K, N)
    center one-hot and a normalised (K, N) aggregation matrix."""
    rng = np.random.default_rng(seed + n * d)
    w = rng.standard_normal((n, d)).astype(np.float32)
    if dtype == "bfloat16":
        w = w.astype(ml_dtypes.bfloat16).astype(np.float32)
    conehot = np.eye(n, dtype=np.float32)[rng.permutation(n)[:k]]
    m = np.eye(k, dtype=np.float32)[rng.integers(0, k, n)].T
    m = m / np.maximum(m.sum(1, keepdims=True), 1.0)
    return w, conehot, m.astype(np.float32)


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("n,k,d,dtype", SWEEP)
def test_plain_center_sq_dists_matches_reference(n, k, d, dtype):
    w, conehot, _ = _inputs(n, k, d, dtype)
    got = ops.center_sq_dists(_torch(w, dtype), torch.from_numpy(conehot))
    kern = jfr.center_sq_dists(_jax(w, dtype), jnp.asarray(conehot),
                               block_d=2048, interpret=True)
    _close(got, kern, TOL[dtype])
    _close(got, jref.center_sq_dists(_jax(w, dtype), jnp.asarray(conehot)),
           TOL[dtype])


@pytest.mark.parametrize("n,k,d,dtype", SWEEP)
def test_plain_fused_coalition_stats_matches_reference(n, k, d, dtype):
    w, _, m = _inputs(n, k, d, dtype)
    got = ops.fused_coalition_stats(_torch(w, dtype), torch.from_numpy(m))
    kern = jfr.fused_coalition_stats(_jax(w, dtype), jnp.asarray(m),
                                     block_d=2048, interpret=True)
    oracle = jref.fused_coalition_stats(_jax(w, dtype), jnp.asarray(m))
    for want in (kern, oracle):
        for g, r in zip(got, want):
            _close(g, r, TOL[dtype])


@pytest.mark.parametrize("n,k,d", [(10, 3, 1000), (7, 2, 129), (16, 8, 8192)])
def test_plain_sq_dists_to_points_matches_reference(n, k, d):
    rng = np.random.default_rng(d)
    w = rng.standard_normal((n, d)).astype(np.float32)
    p = rng.standard_normal((k, d)).astype(np.float32)
    got = ops.sq_dists_to_points(torch.from_numpy(w), torch.from_numpy(p))
    kern = jpd.sq_dists_to_points(jnp.asarray(w), jnp.asarray(p),
                                  block_d=2048, interpret=True)
    _close(got, kern, TOL["float32"])
    _close(got, jref.sq_dists_to_points(jnp.asarray(w), jnp.asarray(p)),
           TOL["float32"])


@pytest.mark.parametrize("n,d,dtype", [
    (4, 257, "float32"), (10, 5000, "float32"), (16, 16384, "float32"),
    (10, 5000, "bfloat16"), (3, 128, "float32"), (32, 1000, "float32")])
def test_plain_pairwise_sq_dists_matches_reference(n, d, dtype):
    w, _, _ = _inputs(n, 1, d, dtype)
    got = ops.pairwise_sq_dists(_torch(w, dtype))
    kern = jpd.pairwise_sq_dists(_jax(w, dtype), block_d=4096,
                                 interpret=True)
    _close(got, kern, TOL[dtype])
    _close(got, jref.pairwise_sq_dists(_jax(w, dtype)), TOL[dtype])
    assert torch.all(torch.diagonal(got) == 0)
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("k,n,d", [(3, 10, 1000), (8, 32, 4097), (2, 4, 64)])
def test_plain_segment_sum_matches_reference(k, n, d):
    rng = np.random.default_rng(k * n * d)
    onehot = np.eye(k, dtype=np.float32)[rng.integers(0, k, n)].T
    onehot = np.ascontiguousarray(onehot)
    w = rng.standard_normal((n, d)).astype(np.float32)
    got = ops.segment_sum(torch.from_numpy(onehot), torch.from_numpy(w))
    kern = jsm.segment_sum(jnp.asarray(onehot), jnp.asarray(w), block_d=512,
                           interpret=True)
    for want in (kern, jref.segment_sum(jnp.asarray(onehot), jnp.asarray(w))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("backend,ref_backend", [
    ("stream", "xla"), ("dot", "dot"), ("cuda", "pallas")])
def test_pairwise_dists_matches_reference(backend, ref_backend):
    """The paper's d(ω_i, ω_j), through each backend pair."""
    w, _, _ = _inputs(8, 1, 3000, "float32")
    got = tdist.pairwise_dists(torch.from_numpy(w), backend=backend)
    want = jdist.pairwise_dists(jnp.asarray(w), backend=ref_backend)
    _close(got, want, 1e-5)


def test_cpu_tensors_take_the_plain_version():
    """ops sends CPU tensors to the plain version: no kernel launch."""
    w, conehot, m = _inputs(6, 2, 300, "float32")
    wt, mt = torch.from_numpy(w), torch.from_numpy(m)
    before = ops.launch_counts()
    ops.center_sq_dists(wt, torch.from_numpy(conehot))
    ops.fused_coalition_stats(wt, mt)
    ops.pairwise_sq_dists(wt)
    ops.sq_dists_to_points(wt, wt[:2])
    ops.segment_sum(mt, wt)
    q = torch.from_numpy(w[:4, :256].reshape(1, 4, 4, 64))
    ops.flash_attention(q, q[:, :2], q[:, :2])
    tcp.conv_relu_pool(torch.rand(2, 1, 28, 28), torch.rand(32, 1, 5, 5),
                       torch.rand(32))
    assert ops.launch_counts() == before
    assert set(before) == {"center_sq_dists", "fused_coalition_stats",
                           "pairwise_sq_dists", "sq_dists_to_points",
                           "segment_sum", "flash_attention",
                           "conv_relu_pool_fwd", "conv_relu_pool_wgrad"}


def test_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on CPU."""
    w, conehot, m = _inputs(6, 2, 300, "float32")
    wt, mt = torch.from_numpy(w), torch.from_numpy(m)
    with pytest.raises(ValueError, match="CUDA"):
        tfr.center_sq_dists(wt, torch.from_numpy(conehot))
    with pytest.raises(ValueError, match="CUDA"):
        tfr.fused_coalition_stats(wt, mt)
    with pytest.raises(ValueError, match="CUDA"):
        tpd.pairwise_sq_dists(wt)
    with pytest.raises(ValueError, match="CUDA"):
        tpd.sq_dists_to_points(wt, wt[:2])
    with pytest.raises(ValueError, match="CUDA"):
        tsm.segment_sum(mt, wt)
    q = torch.from_numpy(w[:4, :256].reshape(1, 4, 4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)
    x = torch.rand(1, 2, 1, 28, 28)
    with pytest.raises(ValueError, match="CUDA"):
        tcp.kernel_forward(x, torch.rand(1, 32, 1, 5, 5), torch.rand(1, 32))
    g = torch.zeros((2, 1, 32, 12, 12))
    with pytest.raises(ValueError, match="CUDA"):
        tcp.kernel_weight_grad(g, g.to(torch.uint8), g, x)


def test_reset_launch_counts_zeroes_every_kernel():
    tpd.LAUNCHES["pairwise_sq_dists"] += 1
    tsm.LAUNCHES["segment_sum"] += 1
    tfa.LAUNCHES["flash_attention"] += 1
    tcp.LAUNCHES["conv_relu_pool_wgrad"] += 1
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


def test_library_names_follow_source_and_flags():
    paths = [build.library_path(src) for src in build.SOURCES]
    assert paths == [build.library_path(src) for src in build.SOURCES]
    assert len(set(paths)) == len(build.SOURCES)
    for src, path in zip(build.SOURCES, paths):
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{Path(src).stem}-")
    for name in build.SOURCES + build.HEADERS:
        assert (build.HERE / name).exists(), name
    assert sorted((build.HERE / "csrc").iterdir()) == sorted(
        build.HERE / name for name in build.SOURCES + build.HEADERS)


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of the port, and chip_smoke.py, leaves jax and
    repro out of sys.modules."""
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for name in ("repro_torch.launch.train", "repro_torch.launch.serve",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.obs.ledger", "repro_torch.obs.timeline",
                 "repro_torch.serve.frontend", "repro_torch.serve.store",
                 "repro_torch.models.tiny_transformer",
                 "repro_torch.core.sharded", "repro_torch.launch.mesh",
                 "repro_torch.launch.sharding"):
        assert name in modules, name
