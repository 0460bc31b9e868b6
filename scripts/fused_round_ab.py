#!/usr/bin/env python
"""Time the register-sweep CUDA kernels of one source tree on the card.

    python3 scripts/fused_round_ab.py [SRC]

SRC is the ``src`` directory of a checkout (default: this checkout's), so
two commits compare in one call on one card: unpack the other commit with
``git archive`` into a directory that ``.gitignore`` lists and run them in
turns (parent, change, change, parent).  It prints, each line beside the
card:
  - the fused round's two kernels at the main path's shape (N = 10, K = 3,
    D = 582,026, f32 and bf16) and at the framework-scale D = 8,000,000
    (f32, N = 10, K = 3 and N = 16, K = 4), with a hash of their outputs
    (two trees whose kernels sum alike print the same hashes) and the
    registers and spills of every fused-round route;
  - ``sq_dists_to_points`` at full width (W f32 or bf16, P f32),
    ``pairwise_sq_dists`` and ``segment_sum`` (W f32 or bf16) at the main
    path's shape and at D = 8M, ``pairwise_sq_dists`` and ``segment_sum``
    also on a base two elements off a 16-byte boundary (two columns a load
    where four would be taken), each with its route (``-`` for a tree
    without a route function) and a hash of its outputs, and the registers
    and spills of every route of the three;
each timed as ``chip_smoke.py`` times it (CUDA events, L2 flushed before
each launch, median of 50), and also with a clean L2, beside its byte
bound.  Exits 1 without a CUDA device.
"""
from __future__ import annotations

import hashlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (its helpers; it imports no kernel here)

#: the main path's shape in f32 and bf16, the framework-scale D, and a shape
#: of the general register tier (N <= 16, K <= 4) at that D
SHAPES = ((10, 3, 582_026, "float32"), (10, 3, 582_026, "bfloat16"),
          (10, 3, chip_smoke.BIG_D, "float32"),
          (16, 4, chip_smoke.BIG_D, "float32"))
#: (N, K, D, W dtype, elements W's base lies past a 16-byte boundary) of
#: the distance and segment-sum kernels (sq_dists_to_points on aligned
#: bases only); P is f32, as the composed round gives it
DIST_SHAPES = ((10, 3, 582_026, "float32", 0),
               (10, 3, 582_026, "bfloat16", 0),
               (10, 3, chip_smoke.BIG_D, "float32", 0),
               (10, 3, chip_smoke.BIG_D, "float32", 2))


def digest(*ts) -> str:
    """A hash of the tensors' bytes: equal for bit-identical outputs."""
    import torch

    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def report(label: str, name: str, shape: str, fn, nbytes: int) -> None:
    ms = chip_smoke.time_ms(fn)
    clean = chip_smoke.time_ms(fn, clean=True)
    bound = nbytes / chip_smoke.PEAK_BYTES * 1e3
    print(f"ab {label} {name} {shape}: {ms * 1e3:.3f} us, clean L2 "
          f"{clean * 1e3:.3f} us, bound {bound * 1e3:.3f} us "
          f"({100 * bound / ms:.1f}%, clean {100 * bound / clean:.1f}%)")


def route_of(mod, fn: str, *args) -> str:
    return getattr(mod, fn)(*args) if hasattr(mod, fn) else "-"


def print_registers(label: str, pd, sm) -> None:
    """Registers and spills of every route of the distance and segment-sum
    kernels (the pairwise ones where the tree has them)."""
    import torch

    dts = (torch.float32, torch.bfloat16)
    rows = [(f"sq_dists_to_points {name} W {str(a)[6:]} P {str(b)[6:]}",
             lambda n=name, a=a, b=b: pd.kernel_attributes(a, b, n))
            for name in pd.ROUTES for a in dts for b in dts]
    if hasattr(pd, "pairwise_kernel_attributes"):
        rows += [(f"pairwise_sq_dists {name} {str(a)[6:]}",
                  lambda n=name, a=a: pd.pairwise_kernel_attributes(a, n))
                 for name in pd.PAIRWISE_ROUTES for a in dts]
    rows += [(f"segment_sum {name} {str(a)[6:]}",
              lambda n=name, a=a: sm.kernel_attributes(a, n))
             for name in sm.ROUTES for a in dts]
    for name, attributes in rows:
        a = attributes()
        print(f"ab {label} {name}: {a['regs']} registers, "
              f"{a['local_bytes']} bytes of local memory")


def main(argv: list[str]) -> int:
    import torch

    src = os.path.abspath(argv[0] if argv else os.path.join(ROOT, "src"))
    sys.path.insert(0, src)
    if not torch.cuda.is_available():
        print("fused_round_ab: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import fused_round as fr
    from repro_torch.kernels import pairwise_dist as pd
    from repro_torch.kernels import segment_mean as sm

    if not fr.__file__.startswith(src):
        raise SystemExit(f"fused_round_ab: imported {fr.__file__}, not {src}")
    label = os.path.relpath(src, ROOT)
    print(chip_smoke.card_line())
    for name in fr.ROUTES:
        for dt in (torch.float32, torch.bfloat16):
            for stats in (False, True):
                a = fr.kernel_attributes(stats, dt, name)
                print(f"ab {label} fused_round {name} {str(dt)[6:]} pass "
                      f"{2 if stats else 1}: {a['regs']} registers, "
                      f"{a['local_bytes']} bytes of local memory")
    print_registers(label, pd, sm)
    for n, k, d, dname in SHAPES:
        w, conehot, m = chip_smoke.inputs(n, k, d, getattr(torch, dname))
        wb = w.numel() * w.element_size()
        shape = f"N={n} K={k} D={d} {dname}"
        outs = (fr.center_sq_dists(w, conehot),
                *fr.fused_coalition_stats(w, m))
        print(f"ab {label} fused_round {shape} outputs {digest(*outs)}")
        del outs
        report(label, "center_sq_dists", shape,
               lambda: fr.center_sq_dists(w, conehot),
               wb + 4 * (k * n + n * k))
        report(label, "fused_coalition_stats", shape,
               lambda: fr.fused_coalition_stats(w, m),
               wb + 4 * (k * n + k * d + d + n * k))
        del w, conehot, m
        torch.cuda.empty_cache()
    for n, k, d, dname, lead in DIST_SHAPES:
        dtype = getattr(torch, dname)
        w0, conehot, m = chip_smoke.inputs(n, k, d, dtype)
        p = (conehot @ w0.float()).contiguous()
        w = torch.empty(n * d + lead, dtype=dtype, device="cuda")
        w = w[lead:].view(n, d)
        w.copy_(w0)
        del w0
        wb = w.numel() * w.element_size()
        shape = f"N={n} K={k} D={d} W {dname} (base +{lead})"
        if lead == 0:
            r = route_of(pd, "route", n, k, d, w.dtype, w.data_ptr(),
                         p.dtype, p.data_ptr())
            print(f"ab {label} sq_dists_to_points {shape} route {r} outputs "
                  f"{digest(pd.sq_dists_to_points(w, p))}")
            report(label, "sq_dists_to_points", shape,
                   lambda: pd.sq_dists_to_points(w, p),
                   wb + 4 * (k * d + n * k))
        r = route_of(pd, "pairwise_route", n, d, w.dtype, w.data_ptr())
        print(f"ab {label} pairwise_sq_dists {shape} route {r} outputs "
              f"{digest(pd.pairwise_sq_dists(w))}")
        report(label, "pairwise_sq_dists", shape,
               lambda: pd.pairwise_sq_dists(w), wb + 4 * n * n)
        r = route_of(sm, "route", n, k, d, w.dtype, w.data_ptr())
        print(f"ab {label} segment_sum {shape} route {r} outputs "
              f"{digest(sm.segment_sum(m, w))}")
        report(label, "segment_sum", shape, lambda: sm.segment_sum(m, w),
               wb + 4 * (k * n + k * d))
        del w, p, conehot, m
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
