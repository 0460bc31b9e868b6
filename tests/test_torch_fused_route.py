"""How the fused-round wrappers pick a kernel by shape, without a card.

``repro_torch.kernels.fused_round.route`` sends N <= REG_N, K <= REG_K to
a register kernel (its own for the exact (N, K) = (10, 3)), with 2-column
loads where D and the base address allow them and 1-column loads
elsewhere, and larger shapes to the tile kernel; it raises outside the
kernels' limits.  The CUDA source's own caps must agree with
the wrapper's (the library checks them again when it loads, on a card).
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import fused_round as tfr
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

F32, BF16 = torch.float32, torch.bfloat16
#: a base address as the caching allocator hands it out (512-byte aligned)
BASE = 1 << 20


@pytest.mark.parametrize("n,k,d,dtype,ptr,want", [
    (10, 3, 582_026, F32, BASE, "exact2"),      # the main path: 8-byte rows
    (10, 3, 582_026, BF16, BASE, "exact2"),     # bf16 rows of 4 bytes
    (10, 3, 8_000_000, F32, BASE, "exact2"),    # framework scale
    (10, 3, 1_000_003, F32, BASE, "exact1"),    # odd D: element rows
    (10, 3, 4096, F32, BASE + 4, "exact1"),     # base one f32 past 8 bytes
    (10, 3, 4096, BF16, BASE + 2, "exact1"),    # base one bf16 past 4 bytes
    (10, 3, 4096, BF16, BASE + 4, "exact2"),
    (16, 4, 70_001, BF16, BASE, "regs1"),
    (1, 1, 1, F32, BASE, "regs1"),
    (2, 2, 2, F32, BASE, "regs2"),
    (10, 1, 4096, F32, BASE, "regs2"),          # N of the exact tier, not K
    (9, 3, 4096, F32, BASE, "regs2"),
    (10, 3, 4096, F32, BASE + 8, "exact2"),
    (16, 4, 4096, F32, BASE, "regs2"),          # the register caps
    (4, 4, 4096, F32, BASE, "regs2"),
    (10, 5, 4096, F32, BASE, "tile"),           # K above the caps
    (17, 3, 4096, F32, BASE, "tile"),           # N above the caps
    (16, 16, 1_000_003, BF16, BASE, "tile"),
    (64, 8, 1_000_003, F32, BASE, "tile"),
    (128, 16, 1, F32, BASE, "tile"),            # the limits
])
def test_route_by_shape(n, k, d, dtype, ptr, want):
    assert tfr.route(n, k, d, dtype, ptr) == want
    assert want in tfr.ROUTES


@pytest.mark.parametrize("n,k,d", [
    (0, 1, 100), (4, 0, 100), (4, 5, 100), (129, 1, 100), (128, 17, 100),
    (10, 3, 0)])
def test_route_refuses_shapes_outside_the_limits(n, k, d):
    with pytest.raises(ValueError, match="limits"):
        tfr.route(n, k, d, F32, BASE)


@pytest.mark.parametrize("n,k", [(128, 16), (64, 32), (1, 1)])
def test_route_takes_the_limits(n, k):
    assert n * k <= tfr.MAX_PAIRS
    assert tfr.route(n, k, 7, F32, BASE) in tfr.ROUTES


def test_cuda_source_caps_match_the_wrapper():
    """The constants of csrc/fused_round.cu are the wrapper's."""
    src = (Path(tfr.__file__).parent / "csrc" / "fused_round.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\w+);", src).group(1))

    assert const("kMaxN") == tfr.MAX_N
    assert const("kRegN") == tfr.REG_N
    assert const("kRegK") == tfr.REG_K
    assert const("kThreads") * const("kMaxItems") == tfr.MAX_PAIRS
    assert (const("kExactN"), const("kExactK")) == tfr.EXACT_NK
    for name, code in tfr.ROUTES.items():
        tier = "Tile" if name == "tile" else name[:-1].title() + name[-1]
        assert const(f"kRoute{tier}") == code


def test_wrappers_check_before_routing():
    """A CPU tensor is refused before any route or build is asked for."""
    w = torch.zeros((200, 10))
    with pytest.raises(ValueError, match="CUDA"):
        tfr.center_sq_dists(w, torch.zeros((1, 200)))
    with pytest.raises(ValueError, match="CUDA"):
        tfr.fused_coalition_stats(w, torch.zeros((300, 200)))
