"""Hierarchical cohort sampling: C active devices out of a fleet of N
(mirrors ``repro.sim.cohort``).

Cohort mode registers fleets of up to millions of devices while a cohort
of C of them trains each round.  The cohort is availability-weighted
**Gumbel top-k**: one Gumbel draw per device plus ``log`` availability,
keep the C largest, which is weighted sampling without replacement.  Top-k
is associative,

    top_C(scores) == top_C( concat_g( top_min(C,|g|)(scores_g) ) )

for any partition into cells g, so the fleet is tiled into cells of
``cell_size`` devices, each cell elects its ``min(C, cell_size)`` best, and
one global top-C over the survivors picks the cohort: equal to flat top-k
over all N scores, with O(cells · C) transient state.  Both levels are
``torch.topk`` on the device of ``weights`` (the reference has no Pallas
kernel here).

Devices with zero effective availability score ``-inf`` and are never
sampled while C positive-weight devices exist (the engine checks that
before round 0).  The Gumbel noise is an input: the parity tests pass the
reference's ``jax.random.gumbel(fold_in(key, r), (N,))`` rows; without it
the rows are drawn from a CPU ``torch.Generator``, so a seed gives the same
cohorts on the CPU and on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: the reference's fold_in tag of the cohort stream; the port offsets its
#: cohort generator's seed by it
COHORT_STREAM = 0xC040

DEFAULT_CELL = 4096


def gumbel_rows(steps: int, n: int, generator: torch.Generator
                ) -> torch.Tensor:
    """(steps, N) float32 standard Gumbel draws ``-log(-log(U))`` from a CPU
    ``generator`` (U kept off 0, as ``jax.random.gumbel`` keeps it)."""
    u = torch.rand((steps, n), generator=generator)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_cohort(weights: torch.Tensor, cohort_size: int, gumbel, *,
                  cell_size: int = DEFAULT_CELL) -> torch.Tensor:
    """One availability-weighted cohort: (C,) distinct int64 device ids.

    ``weights`` is the (N,) effective availability (``sim.effective_p``);
    entries ``<= 0`` are never sampled.  ``gumbel`` is the (N,) noise row
    (moved to ``weights``' device).  Ids come out in descending
    perturbed-score order.
    """
    n = weights.shape[0]
    c = int(cohort_size)
    if not 1 <= c <= n:
        raise ValueError(f"cohort_size must be in [1, {n}], got {c}")
    w = weights.float()
    score = torch.where(w > 0, torch.log(torch.clamp(w, min=1e-38)),
                        torch.full_like(w, -float("inf")))
    score = score + torch.as_tensor(gumbel, dtype=torch.float32,
                                    device=w.device)
    pad = (-n) % cell_size
    if pad:
        score = F.pad(score, (0, pad), value=-float("inf"))
    cells = score.shape[0] // cell_size
    # a cell can hold at most min(C, cell_size) global winners, so the
    # per-cell election loses nothing
    elected, local_ids = torch.topk(score.view(cells, cell_size),
                                    min(c, cell_size), dim=1)
    base = torch.arange(cells, device=w.device)[:, None] * cell_size
    candidate_ids = (local_ids + base).reshape(-1)
    _, winners = torch.topk(elected.reshape(-1), c)
    return candidate_ids[winners]


def sample_cohorts(weights: torch.Tensor, steps: int, cohort_size: int, *,
                   gumbel=None, generator: torch.Generator | None = None,
                   cell_size: int = DEFAULT_CELL) -> torch.Tensor:
    """The run's cohort schedule: (steps, C) int64 on ``weights``' device.

    Row r takes Gumbel row ``gumbel[r]`` (injected) or a row drawn from
    ``generator``; rows are independent draws, one at a time, so the
    N-wide transients never reach (steps, N) on the device.
    """
    if gumbel is None:
        if generator is None:
            raise ValueError("sample_cohorts needs gumbel rows or a "
                             "generator")
        gumbel = gumbel_rows(steps, weights.shape[0], generator)
    return torch.stack([sample_cohort(weights, cohort_size, gumbel[r],
                                      cell_size=cell_size)
                        for r in range(steps)])
