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
points in different dtypes.  The attention kernel is held to the plain
attention with the reference's bounds (rtol = atol = 2e-4 in f32, 2e-2 in
bf16; tests/test_kernels.py) at the reference's sweep and the pretrain
path's shape, on contiguous inputs and on the model's transposed views;
the gradient through ``ops.flash_attention`` to the plain version's at
2e-3.  The bf16 attention kernel (tensor cores) is held at ragged q-tiles
(Sq = 129, 17, 1 against Skv = 300), at every head dim, with windows and
on transposed views, and must refuse views that are not 16-byte aligned;
the f32 kernel (CUDA cores) takes such views.  Non-causal bf16 attention
with no window (the encoder-decoder's encoder) is held at Dh 64 (the
seamless encoder's 16 heads over 960 frames) and Dh 96, and the reduced
encoder-decoder's encoder through the kernel to the same model's on the
CPU.  ``sq_dists_to_points`` is
held at every sketch width D in {1, 64, 255, 256, 1024, 2048}, for each
mix of W and point dtypes, up to its N*K limit and on an unaligned base
(the small-D kernel's element path), and must repeat itself bit for bit.
The fused-round kernels are swept over D at every row alignment, N in
{1, 2, 10, 16, 64} and K in {1, 3, N} on every route (the exact (10, 3)
tier, the general register tier and the tile kernel), in f32 and bf16 and
on an unaligned base; two calls must agree bit for bit, each call must move
its launch counter by one, and no kernel may spill.  ``sq_dists_to_points``
at full width (D > 2048) and ``segment_sum`` are swept the same way over
their register routes and the kernels above them, for every W / points
dtype mix and on bases one element off, with the same checks.
``fused_coalition_stats`` is also held with an aggregation matrix of
fractional masses (the ``semi_async`` engine's staleness weights
``(1 + tau)^-0.5``, tau in 0..4, normalised as ``aggregation_matrix`` does),
and a weighted fused round and a weighted sketched round (one client at
weight 0, which cannot then be elected) on ``cuda`` must equal ``stream``.

The simulation tier on the card: the cohort sampler on the card must give
the CPU's ids from the same Gumbel rows at N = 1,048,576 (and its
hierarchical top-k flat top-k's); an ``event_driven`` run on the card
(the CNN on ``cuda``) must keep the CPU run's fire sets and energy ledger
(arithmetic on the same tables and draws, held exactly), every device's
spend a whole number of its cycle cost within the budget; the attack hooks
on card tensors must equal their CPU results bit for bit (elementwise
f32), and the DP path must bound every delta norm by the clip and match
the CPU with the same noise.

The host side on the card: ``transformer_tiny``'s round on a bf16
(10, 27,626) W (a local phase on the card) must give ``stream``'s
assignment and centers with θ within 5e-6 of its max, launching each
fused kernel once; the ``BatchServer``'s CUDA graph must answer as the
eager forward through each routed model does (within 1e-5 of the max),
capture once, and keep serving after in-place swaps; a federation on the
card checkpointed at round 1 and resumed must reach the uninterrupted
run's assignments and θ.

The SSM scan operator (``repro_torch::ssm_scan``, which has no kernel: its
body is the plain chunk loop on every device) on the card must give the
chunk loop's ``y`` and ``h_last`` on the card bit for bit, at a ragged
length and at the pretrain path's hymba-1.5b shape, and its backward
within 1e-5 of the max of autograd through the loop.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import coalitions as tco
from repro_torch.core import fused as tfz
from repro_torch.core import sketch as tsk
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_round as tfr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise_dist as tpd
from repro_torch.kernels import ref as tref
from repro_torch.kernels import reg_sweep as tsweep
from repro_torch.kernels import segment_mean as tsm
from repro_torch import sim as tsim
from repro_torch.core import client as tclient
from repro_torch.sim import clock as tclock
from repro_torch.testing import cap_cpu_threads, ssm_chunk_loop

cap_cpu_threads()

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


#: (B, Hq, Hkv, Sq, Skv, Dh, causal, window, dtype)
FLASH_SHAPES = [(1, 4, 1, 128, 128, 64, True, None, "float32"),
                (1, 2, 2, 64, 64, 128, False, None, "float32"),
                (1, 4, 4, 100, 100, 80, True, None, "float32"),
                (2, 4, 2, 1, 300, 64, True, None, "float32"),
                (1, 4, 1, 256, 256, 64, True, 64, "float32"),
                (1, 4, 2, 64, 192, 64, True, None, "float32"),
                (1, 8, 8, 70, 70, 96, True, None, "bfloat16"),
                (10, 25, 5, 129, 129, 64, True, 1024, "bfloat16"),
                (10, 25, 5, 129, 129, 64, True, 1024, "float32"),
                (1, 4, 2, 129, 300, 64, True, None, "bfloat16"),
                (1, 4, 2, 17, 300, 64, True, None, "bfloat16"),
                (2, 4, 2, 1, 300, 64, True, None, "bfloat16"),
                (1, 4, 4, 100, 100, 80, True, None, "bfloat16"),
                (1, 2, 2, 64, 64, 128, False, None, "bfloat16"),
                (2, 8, 2, 200, 200, 128, True, None, "bfloat16"),
                (1, 4, 1, 256, 256, 64, True, 64, "bfloat16"),
                (1, 4, 2, 300, 300, 96, True, 100, "bfloat16"),
                (1, 2, 1, 130, 200, 64, False, 50, "bfloat16"),
                (1, 4, 2, 300, 300, 96, True, 100, "float32"),
                (1, 2, 1, 130, 200, 64, False, 50, "float32"),
                # non-causal bf16, no window: the encoder-decoder's encoder
                # (seamless: 16 heads of 64 over 960 frames) and Dh 96
                (1, 16, 16, 960, 960, 64, False, None, "bfloat16"),
                (2, 8, 8, 200, 200, 96, False, None, "bfloat16"),
                (1, 4, 2, 77, 77, 96, False, None, "bfloat16")]


def _flash_inputs(shape, seed=0):
    b, hq, hkv, sq, skv, dh = shape[:6]
    rng = np.random.default_rng(seed + sq * skv + hq)
    dtype = getattr(torch, shape[-1])
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype).cuda()
            for s in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("views", [False, True])
def test_cuda_flash_attention_matches_plain_version(shape, views):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    causal, window, dtype = shape[6:]
    q, k, v = _flash_inputs(shape)
    if views:   # (B, S, H, Dh) storage seen as (B, H, S, Dh), as the model
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    before = tfa.LAUNCHES["flash_attention"]
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == q.dtype and got.is_contiguous()
    want = tref.attention(q, k, v, causal=causal, window=window)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_flash_attention_gradient_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (t.requires_grad_() for t in
               _flash_inputs((1, 4, 2, 64, 64, 64, True, None, "float32")))
    got = torch.autograd.grad(tops.flash_attention(q, k, v).square().sum(),
                              (q, k, v))
    want = torch.autograd.grad(tref.attention(q, k, v).square().sum(),
                               (q, k, v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _flash_inputs((1, 4, 2, 16, 16, 64, True, None, "float32"))
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(TypeError):
        tfa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                            k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_flash_attention_rows_that_see_nothing_write_zero(dtype):
    """Sq > Skv under the causal mask: the first Sq - Skv rows see no key
    and write 0 (the plain version gives NaN there); the rest match."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _flash_inputs((1, 4, 2, 100, 40, 64, True, None, dtype))
    got = tfa.flash_attention(q, k, v).float().cpu()
    want = tref.attention(q, k, v).float().cpu()
    assert torch.all(got[:, :, :60] == 0)
    assert torch.isnan(want[:, :, :60]).all()
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got[:, :, 60:].numpy(),
                               want[:, :, 60:].numpy(), rtol=tol, atol=tol)


def _offset_view(t, lead):
    """t's values in a view whose data pointer is ``lead`` elements past a
    16-byte boundary, last axis contiguous."""
    flat = torch.zeros(t.numel() + lead, dtype=t.dtype, device=t.device)
    view = flat[lead:].view(t.shape)
    view.copy_(t)
    return view


def _padded_view(t, pad):
    """t's values in a view whose rows are ``pad`` elements longer."""
    big = torch.zeros((*t.shape[:-1], t.shape[-1] + pad), dtype=t.dtype,
                      device=t.device)
    big[..., :t.shape[-1]] = t
    return big[..., :t.shape[-1]]


@pytest.mark.cuda
@pytest.mark.parametrize("make", ["offset", "padded"])
def test_cuda_flash_attention_refuses_unaligned_bf16_views(make):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _flash_inputs((1, 4, 2, 33, 33, 64, True, None, "bfloat16"))
    bad = _offset_view(q, 1) if make == "offset" else _padded_view(q, 4)
    assert tfa.misaligned(bad) and not tfa.misaligned(q)
    before = tfa.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention(bad, k, v)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention(q, k, _offset_view(v, 3))
    assert tfa.LAUNCHES["flash_attention"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("make", ["offset", "padded"])
def test_cuda_flash_attention_f32_takes_unaligned_views(make):
    """The f32 kernel (CUDA cores) stages K and V by plain loads: it takes
    views that the bf16 kernel refuses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _flash_inputs((1, 4, 2, 70, 90, 64, True, None, "float32"))
    view = (lambda t: _offset_view(t, 1)) if make == "offset" else (
        lambda t: _padded_view(t, 2))
    got = tfa.flash_attention(view(q), view(k), view(v))
    want = tref.attention(q, k, v)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_flash_attention_kernel_attributes(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for dh in tfa.HEAD_DIMS:
        a = tfa.kernel_attributes(getattr(torch, dtype), dh)
        assert a["threads"] == (128 if dtype == "bfloat16" else 256)
        assert 0 < a["regs"] <= 255
        assert 0 < a["static_smem"] + a["dynamic_smem"] <= 232_448


#: every W / points dtype mix of the small-D distance kernel
MIXES = [("float32", "float32"), ("float32", "bfloat16"),
         ("bfloat16", "float32"), ("bfloat16", "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 64, 255, 256, 1024, 2048])
@pytest.mark.parametrize("wdt,pdt", MIXES)
def test_cuda_sq_dists_to_points_at_sketch_widths(d, wdt, pdt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, _, _ = _inputs(10, 3, d, wdt)
    rng = np.random.default_rng(d + 7)
    p = torch.from_numpy(rng.standard_normal((3, d)).astype(np.float32))
    p = p.to(getattr(torch, pdt)).cuda()
    before = tpd.LAUNCHES["sq_dists_to_points"]
    got = tpd.sq_dists_to_points(w, p)
    again = tpd.sq_dists_to_points(w, p)
    torch.cuda.synchronize()
    assert tpd.LAUNCHES["sq_dists_to_points"] == before + 2
    _close(got, tref.sq_dists_to_points(w, p))
    assert torch.equal(got, again) and torch.all(got >= 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(128, 16, 256), (32, 64, 2048),
                                   (1, 1, 255), (128, 16, 1)])
def test_cuda_sq_dists_to_points_small_d_at_the_limits(n, k, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, _, _ = _inputs(n, 1, d, "float32")
    rng = np.random.default_rng(n * k + d)
    p = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    got = tpd.sq_dists_to_points(w, p.cuda())
    _close(got, tref.sq_dists_to_points(w, p.cuda()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_sq_dists_to_points_on_unaligned_rows(dtype):
    """A contiguous W whose base is not 16-byte aligned takes the small-D
    kernel's element path; it agrees with the vector path's inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, _, _ = _inputs(10, 3, 256, dtype)
    p = w[:3].contiguous()
    shifted = _offset_view(w, 1)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    got = tpd.sq_dists_to_points(shifted, p)
    _close(got, tref.sq_dists_to_points(w, p))
    _close(got, tpd.sq_dists_to_points(w, p))


#: the fused-round sweep: every D at each row alignment (f32 rows of 4, 8
#: and 16 bytes, bf16 rows of 2, 4 and 8), and (N, K) on both register
#: tiers (the exact (10, 3) and N <= 16, K <= 4) and above them (the tile
#: route)
FUSED_D = [1, 2, 3, 255, 257, 4096, 582_026, 1_000_003]
FUSED_NK = [(1, 1), (2, 1), (2, 2), (10, 1), (10, 3), (10, 10), (16, 1),
            (16, 3), (16, 16), (64, 8)]


def _fused_calls(w, conehot, m):
    """Both passes once; each must move its own launch counter by one."""
    before = tfr.LAUNCHES["center_sq_dists"]
    out = tfr.center_sq_dists(w, conehot)
    assert tfr.LAUNCHES["center_sq_dists"] == before + 1
    before = tfr.LAUNCHES["fused_coalition_stats"]
    stats = tfr.fused_coalition_stats(w, m)
    assert tfr.LAUNCHES["fused_coalition_stats"] == before + 1
    return (out, *stats)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", FUSED_D)
@pytest.mark.parametrize("n,k", FUSED_NK)
def test_cuda_fused_round_sweep(n, k, d, dtype):
    """Both passes against their plain versions on every route; two calls
    on the same inputs are bit-identical, and the tickets are back at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, conehot, m = _inputs(n, k, d, dtype)
    first = _fused_calls(w, conehot, m)
    again = _fused_calls(w, conehot, m)
    torch.cuda.synchronize()
    want = (tref.center_sq_dists(w, conehot),
            *tref.fused_coalition_stats(w, m))
    for got, ref in zip(first, want):
        _close(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.all(first[0] >= 0) and torch.all(first[3] >= 0)
    assert all(int(t) == 0 for t in tsweep.TICKETS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_round_on_unaligned_rows(dtype):
    """W whose base is one element past a 16-byte boundary takes a register
    route one column at a time, and agrees with the aligned W."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n, k, tier in ((10, 3, "exact"), (7, 2, "regs")):
        w, conehot, m = _inputs(n, k, 4096, dtype)
        shifted = _offset_view(w, 1)
        assert shifted.is_contiguous()
        assert tfr.route(n, k, 4096, w.dtype, shifted.data_ptr()) == tier + "1"
        assert tfr.route(n, k, 4096, w.dtype, w.data_ptr()) == tier + "2"
        for got, want in zip(_fused_calls(shifted, conehot, m),
                             _fused_calls(w, conehot, m)):
            _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(tfr.ROUTES))
def test_cuda_fused_round_kernels_do_not_spill(name, dtype, stats):
    """No fused-round kernel keeps local memory (ptxas spills)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    attrs = tfr.kernel_attributes(stats, getattr(torch, dtype), name)
    assert attrs["local_bytes"] == 0 and 0 < attrs["regs"] <= 255, attrs


#: the full-width sq_dists_to_points and segment-sum sweeps: (N, K) on the
#: distances' exact (10, 3) tier, the general register tier (N <= 16,
#: K <= 4) and above it (the tile and column kernels)
SWEEP_NK = [(1, 1), (10, 3), (9, 3), (16, 4), (17, 3), (64, 8)]
#: full widths at each row alignment (f32 rows of 4, 8 and 16 bytes)
FULL_D = [2049, 2050, 4096, 582_026, 1_000_003]


def _points(k, d, dtype, seed):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    return p.to(getattr(torch, dtype)).cuda()


def _to_points_calls(w, p):
    """Two calls; each must move the launch counter by one."""
    outs = []
    for _ in range(2):
        before = tpd.LAUNCHES["sq_dists_to_points"]
        outs.append(tpd.sq_dists_to_points(w, p))
        assert tpd.LAUNCHES["sq_dists_to_points"] == before + 1
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("wdt,pdt", MIXES)
@pytest.mark.parametrize("d", FULL_D)
@pytest.mark.parametrize("n,k", SWEEP_NK)
def test_cuda_sq_dists_to_points_full_width_sweep(n, k, d, wdt, pdt):
    """Every full-width route against the plain version; two calls on the
    same inputs are bit-identical, and the tickets are back at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, _, _ = _inputs(n, 1, d, wdt)
    p = _points(k, d, pdt, seed=n * k + d)
    name = tpd.route(n, k, d, w.dtype, w.data_ptr(), p.dtype, p.data_ptr())
    assert name != "warp"
    got, again = _to_points_calls(w, p)
    torch.cuda.synchronize()
    _close(got, tref.sq_dists_to_points(w, p))
    assert torch.equal(got, again) and torch.all(got >= 0)
    assert all(int(t) == 0 for t in tsweep.TICKETS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", FUSED_D)
@pytest.mark.parametrize("n,k", SWEEP_NK)
def test_cuda_segment_sum_sweep(n, k, d, dtype):
    """Every segment-sum route against the plain version, with a weighted
    mix; two calls on the same inputs are bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, _, _ = _inputs(n, 1, d, dtype)
    rng = np.random.default_rng(n + k + d)
    mix = torch.from_numpy(rng.random((k, n)).astype(np.float32)).cuda()
    outs = []
    for _ in range(2):
        before = tsm.LAUNCHES["segment_sum"]
        outs.append(tsm.segment_sum(mix, w))
        assert tsm.LAUNCHES["segment_sum"] == before + 1
    torch.cuda.synchronize()
    _close(outs[0], tref.segment_sum(mix, w))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("wdt,pdt", MIXES)
def test_cuda_sq_dists_to_points_full_width_on_unaligned_rows(wdt, pdt):
    """W or the points one element past a 16-byte boundary take a register
    route one column at a time, and agree with the aligned inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d = 4096
    for n, k, tier in ((10, 3, "exact"), (7, 2, "regs")):
        w, _, _ = _inputs(n, 1, d, wdt)
        p = _points(k, d, pdt, seed=n)
        want = tpd.sq_dists_to_points(w, p)
        assert tpd.route(n, k, d, w.dtype, w.data_ptr(), p.dtype,
                         p.data_ptr()) == tier + "2"
        for ws, ps in ((_offset_view(w, 1), p), (w, _offset_view(p, 1))):
            assert ws.is_contiguous() and ps.is_contiguous()
            assert tpd.route(n, k, d, ws.dtype, ws.data_ptr(), ps.dtype,
                             ps.data_ptr()) == tier + "1"
            _close(tpd.sq_dists_to_points(ws, ps), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_segment_sum_on_unaligned_rows(dtype):
    """W one or two elements past a 16-byte boundary takes a register route
    one or two columns at a time, and agrees with the aligned W."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d = 4096
    for n, k in ((10, 3), (7, 2)):
        w, _, m = _inputs(n, k, d, dtype)
        want = tsm.segment_sum(m, w)
        assert tsm.route(n, k, d, w.dtype, w.data_ptr()) == "regs4"
        for lead, v in ((1, 1), (2, 2)):
            ws = _offset_view(w, lead)
            assert tsm.route(n, k, d, ws.dtype, ws.data_ptr()) == f"regs{v}"
            _close(tsm.segment_sum(m, ws), want)


@pytest.mark.cuda
@pytest.mark.parametrize("wdt,pdt", MIXES)
@pytest.mark.parametrize("name", sorted(tpd.ROUTES))
def test_cuda_sq_dists_to_points_kernels_do_not_spill(name, wdt, pdt):
    """No sq_dists_to_points kernel keeps local memory (ptxas spills)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    attrs = tpd.kernel_attributes(getattr(torch, wdt), getattr(torch, pdt),
                                  name)
    assert attrs["local_bytes"] == 0 and 0 < attrs["regs"] <= 255, attrs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(tsm.ROUTES))
def test_cuda_segment_sum_kernels_do_not_spill(name, dtype):
    """No segment-sum kernel keeps local memory (ptxas spills)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    attrs = tsm.kernel_attributes(getattr(torch, dtype), name)
    assert attrs["local_bytes"] == 0 and 0 < attrs["regs"] <= 255, attrs


#: pairwise_sq_dists on its register routes and around them: (N, D, dtype,
#: elements W's base lies past a 16-byte boundary, route)
PAIR_CAP = tpd.PAIR_REG_N
PAIRWISE_CASES = [(10, 582_026, "float32", 0, "pregs2"),
                  (10, 582_026, "bfloat16", 0, "pregs2"),
                  (10, 8_000_000, "float32", 0, "pregs4"),
                  (PAIR_CAP, 100_000, "float32", 0, "pregs4"),
                  (PAIR_CAP, 100_001, "bfloat16", 0, "pregs1"),
                  (PAIR_CAP + 1, 100_000, "float32", 0, "tile"),
                  (1, 4096, "float32", 0, "pregs4"),
                  (2, 4098, "bfloat16", 0, "pregs2"),
                  (10, 4096, "float32", 1, "pregs1"),
                  (10, 4096, "float32", 2, "pregs2"),
                  (10, 4096, "bfloat16", 1, "pregs1"),
                  (10, 4096, "bfloat16", 2, "pregs2"),
                  (10, 2048, "float32", 0, "tile")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,dtype,lead,want", PAIRWISE_CASES)
def test_cuda_pairwise_sq_dists_routes(n, d, dtype, lead, want):
    """Each pairwise route against the plain version at 5e-6 of the max:
    symmetric bit for bit, the diagonal exactly 0, no value below 0, two
    calls bit-identical, one launch a call, the tickets back at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, _, _ = _inputs(n, 1, d, dtype)
    if lead:
        w = _offset_view(w, lead)
    assert tpd.pairwise_route(n, d, w.dtype, w.data_ptr()) == want
    outs = []
    for _ in range(2):
        before = tpd.LAUNCHES["pairwise_sq_dists"]
        outs.append(tpd.pairwise_sq_dists(w))
        assert tpd.LAUNCHES["pairwise_sq_dists"] == before + 1
    torch.cuda.synchronize()
    got = outs[0]
    _close(got, tref.pairwise_sq_dists(w))
    assert torch.equal(got, got.T) and torch.equal(got, outs[1])
    assert torch.all(torch.diagonal(got) == 0) and torch.all(got >= 0)
    assert all(int(t) == 0 for t in tsweep.TICKETS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(tpd.PAIRWISE_ROUTES))
def test_cuda_pairwise_sq_dists_kernels_do_not_spill(name, dtype):
    """No pairwise_sq_dists kernel keeps local memory (ptxas spills)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    attrs = tpd.pairwise_kernel_attributes(getattr(torch, dtype), name)
    assert attrs["local_bytes"] == 0 and 0 < attrs["regs"] <= 255, attrs


def _stale_masses(n):
    """(N,) staleness-decayed masses (1 + tau)^-0.5, tau = 0..4 in turn."""
    return tclock.staleness_weights(torch.arange(n) % 5, 0.5)


def _fractional_m(n, k, seed=0, weights=None):
    """(K, N) aggregation matrix of fractional masses on the card: a seeded
    assignment, its coalitions' denominators as aggregation_matrix takes
    them (an empty coalition falls back to its center at unit mass)."""
    rng = np.random.default_rng(seed)
    assign = torch.from_numpy(rng.integers(0, k, n))
    centers = torch.from_numpy(rng.permutation(n)[:k])
    if weights is None:
        weights = _stale_masses(n)
    oh_eff, _, denom = tfz.aggregation_matrix(assign, k, centers, weights)
    return (oh_eff / denom[:, None]).contiguous().cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d,dtype", [(10, 3, 582_026, "float32"),
                                         (10, 3, 582_026, "bfloat16"),
                                         (16, 4, 70_001, "float32"),
                                         (64, 8, 100_003, "float32")])
def test_cuda_fused_coalition_stats_with_fractional_masses(n, k, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, _, _ = _inputs(n, k, d, dtype, seed=4)
    m = _fractional_m(n, k, seed=n + d)
    assert not torch.all((m == 0) | (m == m.max(dim=1, keepdim=True).values))
    before = tfr.LAUNCHES["fused_coalition_stats"]
    got = tfr.fused_coalition_stats(w, m)
    torch.cuda.synchronize()
    assert tfr.LAUNCHES["fused_coalition_stats"] == before + 1
    for g, r in zip(got, tref.fused_coalition_stats(w, m)):
        _close(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fused", "sketched countsketch"])
def test_cuda_weighted_round_matches_stream(variant):
    """A round under staleness weights with client 9 at weight 0: equal
    assignment and centers on cuda and stream, θ within 5e-6 of its max,
    the launches of the unweighted round, client 9 never a center."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, k, d = 10, 3, 100_003
    w, _, _ = _inputs(n, k, d, "float32", seed=5)
    w += 5.0 * (torch.arange(n, device="cuda") % k)[:, None]   # separated
    weights = _stale_masses(n).cuda()
    weights[9] = 0.0
    state = tco.init_centers(w, k, perm=torch.arange(n))
    kw, want = {}, {"center_sq_dists": 1, "fused_coalition_stats": 1}
    if variant != "fused":
        kw = {"sketcher": tsk.make_sketcher("countsketch", dim=256)}
        want = {"sq_dists_to_points": 2, "segment_sum": 1}
    tops.reset_launch_counts()
    rc = tco.run_round(w, state, backend="cuda", client_weights=weights, **kw)
    torch.cuda.synchronize()
    moved = {name: c for name, c in tops.launch_counts().items() if c}
    rs = tco.run_round(w, state, backend="stream", client_weights=weights,
                       **kw)
    assert moved == want
    assert torch.equal(rc.assignment, rs.assignment)
    assert torch.equal(rc.new_center_idx, rs.new_center_idx)
    assert 9 not in rc.new_center_idx.tolist()
    _close(rc.theta, rs.theta)
    _close(rc.counts, rs.counts)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,cell", [(1_048_576, 10, 4096),
                                      (100_003, 64, 64)])
def test_cuda_cohort_sampling_matches_cpu(n, c, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(n)
    w = rng.uniform(0.05, 1.0, n).astype(np.float32)
    w[::11] = 0.0
    gumbel = tsim.cohort.gumbel_rows(2, n, torch.Generator().manual_seed(1))
    cpu = tsim.sample_cohorts(torch.from_numpy(w), 2, c, gumbel=gumbel,
                              cell_size=cell)
    card = tsim.sample_cohorts(torch.from_numpy(w).cuda(), 2, c,
                               gumbel=gumbel, cell_size=cell)
    flat = tsim.sample_cohorts(torch.from_numpy(w).cuda(), 2, c,
                               gumbel=gumbel, cell_size=n)
    assert card.is_cuda
    assert torch.equal(card.cpu(), cpu) and torch.equal(flat, card)
    for row in cpu.tolist():
        assert len(set(row)) == c and np.all(w[row] > 0)


def _event_run(device, budget):
    from repro_torch.core.server import Federation, FederationConfig
    from repro_torch.data import loader, partition, synthetic
    from repro_torch.models import zoo

    (x, y), (xte, yte) = synthetic.digits(80, seed=0), \
        synthetic.digits(40, seed=1)
    idx = partition.partition("shard", y, 4, seed=0)
    cd = {k: torch.from_numpy(v).to(device)
          for k, v in loader.client_datasets(x, y, idx).items()}
    model = zoo.make_model("cnn")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device=device)
    cfg = FederationConfig(
        n_clients=4, n_coalitions=2, rounds=3,
        backend="cuda" if device == "cuda" else "stream",
        engine="event_driven",
        client=tclient.ClientConfig(epochs=1),
        sim=tsim.SimConfig(fleet="cellular-flaky", energy_budget=budget,
                           max_events=4))
    xte_t, yte_t = torch.from_numpy(xte).to(device), \
        torch.from_numpy(yte).to(device)
    fed = Federation(model, lambda p: model.accuracy(p, xte_t, yte_t), cfg)
    return fed, fed.run(params, cd, generator=gen)


@pytest.mark.cuda
def test_cuda_event_driven_ledger_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fleet = tsim.make_fleet("cellular-flaky", 4)
    e = tsim.device_event_energy(fleet, 2_328_104).numpy()
    # the dearest device pays its census and retires; a device of at most
    # half its cost survives the census
    budget = float(e.max())
    assert 2 * e.min() <= budget
    fed, (gp, hist) = _event_run("cuda", budget)
    _, (_, want) = _event_run("cpu", budget)
    for field in ("participation", "energy_spent", "energy_exhausted",
                  "event_time", "sim_time", "wan_bytes", "edge_bytes"):
        np.testing.assert_array_equal(getattr(hist.trace, field),
                                      getattr(want.trace, field),
                                      err_msg=field)
    spent = hist.trace.energy_spent
    cycles = spent / e[None, :]
    np.testing.assert_allclose(cycles, np.rint(cycles), rtol=1e-5)
    assert np.all(spent <= budget) and np.all(np.diff(hist.event_times) >= 0)
    exhausted = hist.trace.energy_exhausted[-1]
    assert 0 < exhausted.sum() < len(exhausted)
    assert all(torch.isfinite(v).all() for v in gp.values())
    assert np.all(np.isfinite(hist.test_acc))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(tsim.available_attacks()))
def test_cuda_attack_hooks_match_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    n, d = 10, 582_026
    w = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    theta = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    adv = torch.from_numpy((np.arange(n) % 4 == 1).astype(np.float32))
    atk = tsim.make_attack(name)
    cpu = atk.transform(w, theta, adv, lambda: noise)
    card = atk.transform(w.cuda(), theta.cuda(), adv.cuda(),
                         lambda: noise.cuda())
    assert torch.equal(card.cpu(), cpu)
    clean = atk.transform(w.cuda(), theta.cuda(), torch.zeros(n).cuda(),
                          lambda: noise.cuda())
    assert torch.equal(clean.cpu(), w)
    data = {"x": torch.rand(n, 5, 28, 28, 1),
            "y": torch.randint(0, 10, (n, 5), dtype=torch.int32)}
    got = atk.poison({k: v.cuda() for k, v in data.items()}, adv.cuda())
    want = atk.poison(data, adv)
    for k in data:
        assert torch.equal(got[k].cpu(), want[k])


@pytest.mark.cuda
def test_cuda_dp_path_bounds_norms_and_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(4)
    n, d = 10, 582_026
    theta = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    w = theta + torch.from_numpy(
        (rng.standard_normal((n, d)) * np.linspace(1e-4, 1e-2, n)[:, None])
        .astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    for sigma in (0.0, 0.5):
        cfg = tclient.ClientConfig(dp_clip=1.0, dp_sigma=sigma)
        card = tclient.privatize(w.cuda(), theta.cuda(), cfg,
                                 noise=noise.cuda())
        cpu = tclient.privatize(w, theta, cfg, noise=noise)
        _close(card, cpu)
        if sigma == 0.0:
            norms = torch.linalg.vector_norm(card - theta.cuda(), dim=1)
            assert torch.all(norms <= 1.0 * (1 + 1e-6))
            clipped = card
    drawn = tclient.privatize(w.cuda(), theta.cuda(), tclient.ClientConfig(
        dp_clip=1.0, dp_sigma=0.5),
        generator=torch.Generator(device="cuda").manual_seed(0))
    std = float(torch.std(drawn - clipped))
    assert abs(std / 0.5 - 1.0) < 0.02


@pytest.mark.cuda
def test_cuda_encoder_through_the_kernel_matches_cpu():
    """The reduced encoder-decoder (f32, Dh 64) with the flash switch on:
    its encoder launches the kernel once a layer, non-causally, and its
    memory and prefill logits match the CPU model's (plain attention) at
    the kernel's f32 bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get, reduced
    from repro_torch.models import encdec, layers
    from repro_torch.models import transformer as tf

    cfg = reduced(get("seamless-m4t-large-v2"))
    cpu = tf.init(torch.Generator().manual_seed(0), cfg)
    card = tf.init(torch.Generator().manual_seed(0), cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9))),
             "modal": torch.from_numpy(rng.standard_normal(
                 (2, cfg.n_modal_tokens, cfg.d_modal)).astype(np.float32))}
    on_card = {k: v.cuda() for k, v in batch.items()}
    with torch.no_grad():
        want_mem = encdec.encode(cpu, batch["modal"])
        want, _ = tf.prefill(cpu, batch, tf.init_cache(cfg, 2, 12))
        layers.set_flash_kernel(True)
        try:
            before = tfa.LAUNCHES["flash_attention"]
            mem = encdec.encode(card, on_card["modal"])
            got, _ = tf.prefill(card, on_card,
                                tf.init_cache(cfg, 2, 12, device="cuda"))
            torch.cuda.synchronize()
            launched = tfa.LAUNCHES["flash_attention"] - before
        finally:
            layers.set_flash_kernel(False)
    assert launched == 2 * cfg.n_enc_layers
    np.testing.assert_allclose(mem.cpu().numpy(), want_mem.numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def _tiny_w(n=10, seed=0):
    """A bf16 (n, 27,626) W from one local phase of transformer_tiny on the
    card, each client's shard a cluster of its own label."""
    from repro_torch.core import pytree
    from repro_torch.data import synthetic
    from repro_torch.models import zoo

    model = zoo.make_model("transformer_tiny")
    params = model.init(torch.Generator().manual_seed(seed), device="cuda")
    x, y = synthetic.digits(n * 20, seed=seed)
    order = np.argsort(y % 3, kind="stable").reshape(n, 20)
    data = {"x": torch.from_numpy(x[order]).cuda(),
            "y": torch.from_numpy(y[order]).cuda()}
    perms = torch.stack([torch.stack([torch.randperm(
        20, generator=torch.Generator().manual_seed(i))]) for i in range(n)])
    stacked, _ = tclient.local_phase(model.loss_fn, params, data,
                                     perms.cuda(),
                                     tclient.ClientConfig(epochs=1))
    return pytree.client_matrix(stacked, model.layout)


@pytest.mark.cuda
def test_cuda_tiny_transformer_round_matches_stream():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w = _tiny_w()
    assert w.dtype == torch.bfloat16 and w.shape == (10, 27_626)
    state = tco.init_centers(w, 3, perm=torch.arange(10))
    tops.reset_launch_counts()
    rc = tco.run_round(w, state, backend="cuda")
    torch.cuda.synchronize()
    moved = {name: c for name, c in tops.launch_counts().items() if c}
    rs = tco.run_round(w, state, backend="stream")
    assert moved == {"center_sq_dists": 1, "fused_coalition_stats": 1}
    assert torch.equal(rc.assignment, rs.assignment)
    assert torch.equal(rc.new_center_idx, rs.new_center_idx)
    _close(rc.theta, rs.theta)
    _close(rc.barycenters, rs.barycenters)


@pytest.mark.cuda
def test_cuda_batch_server_graph_matches_eager():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import pytree
    from repro_torch.models import cnn
    from repro_torch.serve import BatchServer, Snapshot

    def snapshot(r):
        g = torch.Generator().manual_seed(r)
        params = cnn.init(g)
        theta = pytree.flatten(params, cnn.REF_LAYOUT)
        bary = theta[None] + 0.05 * torch.randn((3, theta.shape[0]),
                                                generator=g)
        return Snapshot(round=r, global_params=pytree.to_ref_tree(
            params, cnn.REF_LAYOUT), barycenters=bary.cuda(),
            assignment=(np.arange(10) + r) % 3, counts=None, meta={})

    server = BatchServer(cnn.apply, cnn.REF_LAYOUT, snapshot(0),
                         device="cuda")
    ptrs = {k: v.data_ptr() for k, v in server._stacked.items()}
    ids = np.array(list(range(10)) + [-1, 42])
    x = torch.randn((12, 28, 28, 1), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    for r in range(3):
        if r:
            server.swap(snapshot(r))
        got = server.serve(ids, x)
        rows = server.routing.model_rows(ids)
        with torch.no_grad():
            for q, row in enumerate(rows):
                want = cnn.apply(server.model_params(int(row)), x)[q]
                err = float((got[q] - want).abs().max())
                assert err <= 1e-5 * float(want.abs().max()), (r, q, err)
    assert server.compile_count == 1 and server.round == 2
    assert {k: v.data_ptr() for k, v in server._stacked.items()} == ptrs


@pytest.mark.cuda
def test_cuda_federation_resume_matches_uninterrupted(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import shutil

    from repro_torch.core.server import Federation, FederationConfig
    from repro_torch.models import zoo

    def loss(p, batch):
        return torch.nn.functional.cross_entropy(
            batch["x"] @ p["w"] + p["b"], batch["y"])

    model = zoo.FLModel(name="linear", init=None, loss_fn=loss,
                        accuracy=None,
                        layout=(("b", "b", None), ("w", "w", None)))
    rng = np.random.default_rng(0)
    data = {"x": torch.from_numpy(rng.standard_normal((6, 16, 8)).astype(
        np.float32)).cuda(),
        "y": torch.from_numpy(rng.integers(0, 4, (6, 16))).cuda()}
    params = {"w": torch.zeros((8, 4), device="cuda"),
              "b": torch.zeros(4, device="cuda")}
    cfg = FederationConfig(n_clients=6, n_coalitions=2, rounds=3,
                           backend="cuda",
                           client=tclient.ClientConfig(epochs=1,
                                                       batch_size=4))

    def run(**kw):
        return Federation(model, lambda p: p["w"].sum(), cfg).run(
            params, data, generator=torch.Generator().manual_seed(3), **kw)

    gp, hist = run()
    run(ckpt_every=1, ckpt_dir=str(tmp_path))
    shutil.rmtree(tmp_path / "step_00000002")
    gp2, hist2 = run(ckpt_dir=str(tmp_path), resume=True)
    assert hist2.assignments == hist.assignments
    _close(gp2["w"], gp["w"])


#: the sharded round's column tiles (repro_torch.core.sharded): (D, P, the
#: rank's tile).  D = 582,026 over 2 is 291,013 columns, odd, so rows are
#: only 4-byte aligned in f32 and the sweep loads one column at a time;
#: over 4 the last tile ends in 2 zero columns; rank 1's tile is cut from
#: the middle of W
TILE_CASES = [(582_026, 2, 0), (582_026, 2, 1), (582_026, 4, 3),
              (8_000_000, 2, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,parts,rank", TILE_CASES)
def test_cuda_kernels_on_column_tiles(d, parts, rank, dtype):
    """The fused round's two kernels and segment_sum on a rank's
    contiguous tile against their plain versions on that tile, and equal
    bit for bit to the tile's columns of the whole W's barycenters, θ and
    segment sums (each column's arithmetic does not depend on the tiling);
    the padding columns zero.  The partial pass-1 distances of all tiles sum
    to the whole W's within 5e-6 of max."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import sharded

    n, k = 10, 3
    w, conehot, m = _inputs(n, k, d, dtype)
    tile = sharded.cut_tile(w, parts, rank)
    width = -(-d // parts)
    lo, valid = rank * width, min(width, d - rank * width)
    assert tile.is_contiguous() and tile.shape == (n, width)
    if dtype == "float32" and width % 2:
        assert tfr.route(n, k, width, tile.dtype, tile.data_ptr()) == "exact1"
    got = _fused_calls(tile, conehot, m)
    mix = m.contiguous()
    seg = tsm.segment_sum(mix, tile)
    torch.cuda.synchronize()
    want = (tref.center_sq_dists(tile, conehot),
            *tref.fused_coalition_stats(tile, m))
    for g, r in zip(got, want):
        _close(g, r)
    _close(seg, tref.segment_sum(mix, tile))
    _, b, theta, _ = got
    _, b_all, theta_all, _ = _fused_calls(w, conehot, m)
    seg_all = tsm.segment_sum(mix, w)
    assert torch.equal(b[:, :valid], b_all[:, lo:lo + valid])
    assert torch.equal(theta[:valid], theta_all[lo:lo + valid])
    assert torch.equal(seg[:, :valid], seg_all[:, lo:lo + valid])
    assert not b[:, valid:].any() and not seg[:, valid:].any()
    partial = sum(tfr.center_sq_dists(sharded.cut_tile(w, parts, r), conehot)
                  for r in range(parts))
    _close(partial, tfr.center_sq_dists(w, conehot))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_one_rank_sharded_round_is_dense(dtype):
    """The sharded cuda round on a one-rank mesh (over nccl, or the gloo
    group of an earlier test) equals the dense cuda round bit for bit, each
    kernel launched once.  A group started here is ended here, so the CPU
    meshes of later tests do not meet nccl."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from repro_torch.core import sharded
    from repro_torch.launch import mesh as mesh_lib

    started = not dist.is_initialized()
    mesh_lib.init_distributed("cuda")
    try:
        mesh = mesh_lib.parse_mesh("data=1")
        w, _, _ = _inputs(10, 3, 582_026, dtype)
        ci = torch.tensor([0, 4, 7], device="cuda")
        dense = tfz.fused_round(w, ci, backend="cuda")
        before = dict(tfr.LAUNCHES)
        got = tfz.fused_round(w, ci, backend=sharded.sharded_backend(
            "cuda", mesh))
        torch.cuda.synchronize()
    finally:
        if started:
            dist.destroy_process_group()
    assert all(tfr.LAUNCHES[name] == before[name] + 1 for name in before)
    for f in dense._fields:
        assert torch.equal(getattr(dense, f), getattr(got, f)), f


#: (B, S, d_inner, N): a ragged length (3 chunks and 8 steps) and the
#: pretrain path's hymba-1.5b layer (batch 10 x 129 tokens)
SSM_SHAPES = [(2, 200, 256, 16), (10, 129, 3200, 16)]


def _ssm_inputs(b, s, di, n, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [np.logaddexp(0.0, rng.standard_normal((b, s, di))),
              rng.standard_normal((b, s, di)), rng.standard_normal((b, s, n)),
              rng.standard_normal((b, s, n)),
              -np.tile(np.arange(1, n + 1), (di, 1)) / 10.0,
              rng.standard_normal((b, di, n))]
    return [torch.from_numpy(np.asarray(x, np.float32)).cuda()
            for x in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,di,n", SSM_SHAPES)
def test_cuda_ssm_scan_is_the_chunk_loop(b, s, di, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models import ssm_scan

    xs = _ssm_inputs(b, s, di, n)
    with torch.no_grad():
        want_y, want_h = ssm_chunk_loop(*xs, 64)
        y, h, _ = torch.ops.repro_torch.ssm_scan(*xs, 64, False)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    rng = np.random.default_rng(1)
    gy = torch.from_numpy(rng.standard_normal((b, s, di)).astype(
        np.float32)).cuda()
    gh = torch.from_numpy(rng.standard_normal((b, di, n)).astype(
        np.float32)).cuda()
    grads = []
    for run in (ssm_chunk_loop, ssm_scan.scan):
        leaves = [x.clone().requires_grad_() for x in xs]
        y, h = run(*leaves, 64)
        assert torch.equal(y, want_y) and torch.equal(h, want_h)
        grads.append(torch.autograd.grad((y, h), leaves, (gy, gh)))
    for want, got in zip(*grads):
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err
