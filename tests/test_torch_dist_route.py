"""How the distance and segment-sum wrappers pick a kernel, without a card.

``repro_torch.kernels.pairwise_dist.route`` sends ``sq_dists_to_points``
to the warp kernel at the sketch widths (D <= SMALL_D), to a register
kernel at full width for N <= REG_N, K <= REG_K (its own for the exact
(N, K) = (10, 3)), with 2-column loads where D and both bases allow them
and 1-column loads elsewhere, and to the tile kernel above the caps.
``repro_torch.kernels.pairwise_dist.pairwise_route`` sends
``pairwise_sq_dists`` to the pairwise register kernel at full width for
N <= PAIR_REG_N, with 4-, 2- or 1-column loads by D and W's base, and to
the tile kernel above the cap and at D <= SMALL_D.
``repro_torch.kernels.segment_mean.route`` sends ``segment_sum`` to a
register kernel with 4-, 2- or 1-column loads by D and W's base, and to
the column kernel above the caps.  Both raise outside the kernels' limits
without building anything, and the CUDA sources' constants must agree with
the wrappers' (the libraries check them again when they load, on a card).
The plain versions the CPU path takes are held to the reference's at the
register routes' shapes.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pairwise_dist as jpd
from repro.kernels import ref as jref
from repro.kernels import segment_mean as jsm
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_dist as tpd
from repro_torch.kernels import reg_sweep
from repro_torch.kernels import segment_mean as tsm
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

F32, BF16 = torch.float32, torch.bfloat16
#: a base address as the caching allocator hands it out (512-byte aligned)
BASE = 1 << 20
CSRC = Path(tpd.__file__).parent / "csrc"


@pytest.mark.parametrize("n,k,d,wdt,wp,pdt,pp,want", [
    (10, 3, 582_026, F32, BASE, F32, BASE, "exact2"),   # the composed round
    (10, 3, 582_026, BF16, BASE, F32, BASE, "exact2"),  # bf16 W, f32 b
    (10, 3, 8_000_000, F32, BASE, F32, BASE, "exact2"),
    (10, 3, 1_000_003, F32, BASE, F32, BASE, "exact1"),  # odd D
    (10, 3, 2049, F32, BASE, F32, BASE, "exact1"),      # past the warp kernel
    (10, 3, 2050, F32, BASE, BF16, BASE, "exact2"),
    (10, 3, 4096, F32, BASE + 4, F32, BASE, "exact1"),  # W one f32 off
    (10, 3, 4096, F32, BASE, F32, BASE + 4, "exact1"),  # P one f32 off
    (10, 3, 4096, BF16, BASE, BF16, BASE + 2, "exact1"),
    (10, 3, 4096, BF16, BASE + 4, BF16, BASE + 8, "exact2"),
    (1, 1, 4096, F32, BASE, F32, BASE, "regs2"),
    (9, 3, 4096, F32, BASE, BF16, BASE, "regs2"),
    (3, 10, 4096, F32, BASE, F32, BASE, "tile"),        # K above the caps
    (16, 4, 582_026, BF16, BASE, BF16, BASE, "regs2"),  # the register caps
    (16, 4, 4097, F32, BASE, F32, BASE, "regs1"),
    (17, 3, 4096, F32, BASE, F32, BASE, "tile"),        # N above the caps
    (10, 5, 4096, F32, BASE, F32, BASE, "tile"),
    (64, 8, 1_000_003, F32, BASE, F32, BASE, "tile"),
    (10, 3, 2048, F32, BASE, F32, BASE, "warp"),        # the sketch widths
    (10, 3, 256, BF16, BASE + 2, F32, BASE, "warp"),
    (128, 16, 1, F32, BASE, F32, BASE, "warp"),         # the limits
    (32, 64, 4096, F32, BASE, F32, BASE, "tile"),
])
def test_sq_dists_to_points_route_by_shape(n, k, d, wdt, wp, pdt, pp, want):
    assert tpd.route(n, k, d, wdt, wp, pdt, pp) == want
    assert want in tpd.ROUTES


@pytest.mark.parametrize("n,k,d", [
    (0, 1, 100), (4, 0, 100), (129, 1, 100), (4, 65, 100), (64, 33, 100),
    (10, 3, 0)])
def test_sq_dists_to_points_route_refuses_shapes_outside_the_limits(n, k, d):
    with pytest.raises(ValueError, match="limits"):
        tpd.route(n, k, d, F32, BASE, F32, BASE)


CAP = tpd.PAIR_REG_N


@pytest.mark.parametrize("n,d,dtype,ptr,want", [
    (10, 582_026, F32, BASE, "pregs2"),       # the main width: 8-byte rows
    (10, 582_026, BF16, BASE, "pregs2"),
    (10, 8_000_000, F32, BASE, "pregs4"),     # framework scale
    (10, 8_000_000, F32, BASE + 8, "pregs2"),
    (10, 8_000_000, F32, BASE + 4, "pregs1"),
    (10, 8_000_000, BF16, BASE + 8, "pregs4"),
    (10, 8_000_000, BF16, BASE + 4, "pregs2"),
    (10, 8_000_000, BF16, BASE + 2, "pregs1"),
    (10, 1_000_003, F32, BASE, "pregs1"),     # odd D
    (10, 2049, F32, BASE, "pregs1"),          # past the sketch widths
    (2, 4098, F32, BASE, "pregs2"),
    (1, 4096, F32, BASE, "pregs4"),
    (CAP, 4096, BF16, BASE, "pregs4"),        # the register cap
    (CAP, 70_001, F32, BASE, "pregs1"),
    (CAP + 1, 4096, F32, BASE, "tile"),       # above the cap
    (16, 582_026, F32, BASE, "tile"),
    (64, 1_000_003, F32, BASE, "tile"),       # the limit
    (10, 2048, F32, BASE, "tile"),            # the sketch widths
    (10, 256, BF16, BASE, "tile"),
    (1, 1, F32, BASE, "tile"),
])
def test_pairwise_route_by_shape(n, d, dtype, ptr, want):
    assert tpd.pairwise_route(n, d, dtype, ptr) == want
    assert want in tpd.PAIRWISE_ROUTES


@pytest.mark.parametrize("n,d", [(0, 100), (65, 100), (10, 0), (65, 4096)])
def test_pairwise_route_refuses_shapes_outside_the_limits(n, d):
    with pytest.raises(ValueError, match="limits"):
        tpd.pairwise_route(n, d, F32, BASE)


@pytest.mark.parametrize("n,k,d,dtype,ptr,want", [
    (10, 3, 582_026, F32, BASE, "regs2"),      # the main width: 8-byte rows
    (10, 3, 582_026, BF16, BASE, "regs2"),
    (10, 3, 8_000_000, F32, BASE, "regs4"),    # framework scale
    (10, 3, 8_000_000, F32, BASE + 8, "regs2"),
    (10, 3, 8_000_000, F32, BASE + 4, "regs1"),
    (10, 3, 8_000_000, BF16, BASE + 8, "regs4"),
    (10, 3, 8_000_000, BF16, BASE + 4, "regs2"),
    (10, 3, 1_000_003, F32, BASE, "regs1"),    # odd D
    (10, 3, 1, F32, BASE, "regs1"),
    (1, 1, 4096, F32, BASE, "regs4"),
    (9, 3, 4098, BF16, BASE, "regs2"),
    (16, 4, 70_001, BF16, BASE, "regs1"),      # the register caps
    (3, 10, 4096, F32, BASE, "cols"),          # K above the caps
    (17, 3, 4096, F32, BASE, "cols"),          # N above the caps
    (64, 8, 100_003, F32, BASE, "cols"),
    (12288, 1, 7, F32, BASE, "cols"),          # the limit
])
def test_segment_sum_route_by_shape(n, k, d, dtype, ptr, want):
    assert tsm.route(n, k, d, dtype, ptr) == want
    assert want in tsm.ROUTES


@pytest.mark.parametrize("n,k,d", [
    (0, 1, 100), (4, 0, 100), (4097, 3, 100), (10, 3, 0)])
def test_segment_sum_route_refuses_shapes_outside_the_limits(n, k, d):
    with pytest.raises(ValueError, match="limits"):
        tsm.route(n, k, d, F32, BASE)


@pytest.mark.parametrize("d,widths,bases,want", [
    (8, (4, 2), ((F32, BASE),), 4),
    (8, (4, 2), ((F32, BASE + 8),), 2),
    (8, (4, 2), ((F32, BASE + 4),), 1),
    (6, (4, 2), ((F32, BASE),), 2),
    (8, (2,), ((F32, BASE), (BF16, BASE + 2)), 1),
    (8, (2,), ((F32, BASE), (BF16, BASE + 4)), 2),
    (7, (4, 2), ((BF16, BASE),), 1),
])
def test_vector_width_follows_d_and_every_base(d, widths, bases, want):
    assert reg_sweep.vector_width(d, widths, *bases) == want


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\w+);", src).group(1))


def test_pairwise_dist_source_caps_match_the_wrapper():
    """The constants of csrc/pairwise_dist.cu are the wrapper's."""
    src = (CSRC / "pairwise_dist.cu").read_text()
    assert _const(src, "kMaxN") == tpd.MAX_N
    assert _const(src, "kMaxK") == tpd.MAX_K
    assert _const(src, "kMaxPairwiseN") == tpd.MAX_PAIRWISE_N
    assert "constexpr long long kSmallD = 8 * kTile;" in src
    assert "constexpr int kTile = kThreads;" in src
    assert 8 * _const(src, "kThreads") == tpd.SMALL_D
    assert _const(src, "kRegN") == tpd.REG_N
    assert _const(src, "kRegK") == tpd.REG_K
    assert (_const(src, "kExactN"), _const(src, "kExactK")) == tpd.EXACT_NK
    assert "constexpr int kMaxPairs = kThreads * kMaxItems;" in src
    assert _const(src, "kThreads") * _const(src, "kMaxItems") == tpd.MAX_PAIRS
    for name, code in (*tpd.ROUTES.items(), *tpd.PAIRWISE_ROUTES.items()):
        tier = name[:-1].title() + name[-1] if name[-1].isdigit() \
            else name.title()
        assert _const(src, f"kRoute{tier}") == code
    assert _const(src, "kPairRegN") == tpd.PAIR_REG_N
    assert "using PairTier = Tier<kPairRegN, 1, false, 1, false, " in src
    codes = list(tpd.ROUTES.values()) + list(tpd.PAIRWISE_ROUTES.values())
    assert len(set(codes)) == len(codes) - 1      # "tile" is in both


def test_segment_mean_source_caps_match_the_wrapper():
    """The constants of csrc/segment_mean.cu are the wrapper's."""
    src = (CSRC / "segment_mean.cu").read_text()
    assert _const(src, "kMaxMix") == tsm.MAX_MIX
    assert _const(src, "kRegN") == tsm.REG_N
    assert _const(src, "kRegK") == tsm.REG_K
    for name, code in tsm.ROUTES.items():
        tier = name[:-1].title() + name[-1] if name[-1].isdigit() \
            else name.title()
        assert _const(src, f"kRoute{tier}") == code


def test_sources_include_the_shared_sweep():
    """The fused-round, distance and segment-sum sources share reg_sweep.cuh,
    which holds the sweep, the CTA sum and the ticket tail; no source keeps
    a copy of its own."""
    parts = ("struct Tier", "void sweep(", "void cta_sum(", "void grid_tail(",
             "void load_step(", "void load_cols(")
    for name in ("fused_round.cu", "pairwise_dist.cu", "segment_mean.cu"):
        src = (CSRC / name).read_text()
        assert '#include "reg_sweep.cuh"' in src, name
        for part in parts:
            assert part not in src, (name, part)
    shared = (CSRC / "reg_sweep.cuh").read_text()
    for part in parts:
        assert part in shared, part


def test_wrappers_check_before_routing():
    """A CPU tensor is refused before any route or build is asked for."""
    w = torch.zeros((10, 4096))
    with pytest.raises(ValueError, match="CUDA"):
        tpd.sq_dists_to_points(w, w[:3])
    with pytest.raises(ValueError, match="CUDA"):
        tpd.pairwise_sq_dists(w)
    with pytest.raises(ValueError, match="CUDA"):
        tsm.segment_sum(torch.zeros((3, 10)), w)


@pytest.mark.parametrize("n,k,d", [(10, 3, 4099), (16, 4, 2050), (1, 1, 3000),
                                   (17, 3, 2049)])
def test_plain_sq_dists_to_points_at_full_width_matches_reference(n, k, d):
    """The CPU path at the register and tile routes' shapes, against the
    reference's Pallas kernel (interpret mode) at 5e-6 of the max."""
    rng = np.random.default_rng(n * k + d)
    w = rng.standard_normal((n, d)).astype(np.float32)
    p = rng.standard_normal((k, d)).astype(np.float32)
    got = ops.sq_dists_to_points(torch.from_numpy(w), torch.from_numpy(p))
    want = np.asarray(jpd.sq_dists_to_points(jnp.asarray(w), jnp.asarray(p),
                                             block_d=2048, interpret=True))
    err = np.abs(got.numpy().astype(np.float64) - want).max()
    assert err <= 5e-6 * (np.abs(want).max() + 1e-6)


@pytest.mark.parametrize("k,n,d", [(3, 10, 4100), (4, 16, 2050), (1, 1, 513),
                                   (3, 17, 1000)])
def test_plain_segment_sum_matches_reference_with_weights(k, n, d):
    """The CPU path with a weighted (K, N) mix, as the aggregation matrix
    with client weights gives it, against the reference's Pallas kernel
    (interpret mode) at its rtol 1e-5, atol 1e-4."""
    rng = np.random.default_rng(k * n * d)
    mix = rng.random((k, n)).astype(np.float32)
    w = rng.standard_normal((n, d)).astype(np.float32)
    got = ops.segment_sum(torch.from_numpy(mix), torch.from_numpy(w))
    want = jsm.segment_sum(jnp.asarray(mix), jnp.asarray(w), block_d=512,
                           interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("d", [4099, 4098])     # odd; even, not a multiple of 4
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_pairwise_sq_dists_at_full_width_matches_reference(d, dtype):
    """The CPU path at the pairwise register routes' widths (pregs1 at odd
    D, pregs2 at even D not a multiple of 4), against the reference's
    Pallas kernel (interpret mode) and its ref, on the same numpy W, within
    the reference's bounds (tests/test_kernels.py: 5e-6 of the max in f32,
    5e-3 in bf16)."""
    rng = np.random.default_rng(d)
    w = rng.standard_normal((10, d)).astype(np.float32)
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    got = ops.pairwise_sq_dists(tw).numpy()
    tol = 5e-3 if dtype == "bfloat16" else 5e-6
    for want in (jpd.pairwise_sq_dists(jw, block_d=4096, interpret=True),
                 jref.pairwise_sq_dists(jw)):
        want = np.asarray(jax.device_get(want))
        scale = float(want.max()) + 1e-6
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=tol)
    assert np.all(np.diagonal(got) == 0) and np.array_equal(got, got.T)
    assert tpd.pairwise_route(10, d, tw.dtype, BASE) == (
        "pregs1" if d % 2 else "pregs2")
