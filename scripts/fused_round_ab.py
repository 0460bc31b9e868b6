#!/usr/bin/env python
"""Time the fused round's two CUDA kernels of one source tree on the card.

    python3 scripts/fused_round_ab.py [SRC]

SRC is the ``src`` directory of a checkout (default: this checkout's), so
two commits compare in one call on one card: unpack the other commit with
``git archive`` into a directory that ``.gitignore`` lists and run them in
turns (parent, change, change, parent).  Each line gives one kernel's time
at the main path's shape (N = 10, K = 3, D = 582,026, f32 and bf16) and at
the framework-scale D = 8,000,000 (f32, N = 10, K = 3 and N = 16, K = 4),
timed as ``chip_smoke.py`` times it (CUDA events, L2 flushed before each
launch, median of 50), beside its byte bound and the card.  Exits 1
without a CUDA device.
"""
from __future__ import annotations

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


def main(argv: list[str]) -> int:
    import torch

    src = os.path.abspath(argv[0] if argv else os.path.join(ROOT, "src"))
    sys.path.insert(0, src)
    if not torch.cuda.is_available():
        print("fused_round_ab: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import fused_round as fr

    if not fr.__file__.startswith(src):
        raise SystemExit(f"fused_round_ab: imported {fr.__file__}, not {src}")
    label = os.path.relpath(src, ROOT)
    print(chip_smoke.card_line())
    for n, k, d, dname in SHAPES:
        w, conehot, m = chip_smoke.inputs(n, k, d, getattr(torch, dname))
        wb = w.numel() * w.element_size()
        runs = (("center_sq_dists", lambda: fr.center_sq_dists(w, conehot),
                 wb + 4 * (k * n + n * k)),
                ("fused_coalition_stats",
                 lambda: fr.fused_coalition_stats(w, m),
                 wb + 4 * (k * n + k * d + d + n * k)))
        for name, fn, nbytes in runs:
            ms = chip_smoke.time_ms(fn)
            bound = nbytes / chip_smoke.PEAK_BYTES * 1e3
            print(f"ab {label} {name} N={n} K={k} D={d} {dname}: "
                  f"{ms * 1e3:.3f} us, bound {bound * 1e3:.3f} us "
                  f"({100 * bound / ms:.1f}%)")
        del w, conehot, m
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
