"""Coalition-dynamics metrics (pure O(N·K) algebra, no W sweeps).

They turn what the fused round already materializes — the assignment, the
coalition masses, the (N, K) client→barycenter distances and the previous
round's assignment/barycenters — into per-round observables:

  :func:`membership_churn`  — fraction of clients whose coalition flipped.
  :func:`size_entropy`      — Shannon entropy (nats) of the coalition sizes.
  :func:`intra_radius`      — per-coalition RMS member→barycenter distance.
  :func:`barycenter_drift`  — per-coalition ‖b_k(r) − b_k(r−1)‖.

This module must not import ``repro_torch.core`` (the core round imports it).
"""
from __future__ import annotations

import torch

#: far below any real (even fractional) coalition mass; only dodges 0/0
_EPS = 1e-12


def membership_churn(assignment: torch.Tensor,
                     prev_assignment: torch.Tensor) -> torch.Tensor:
    """Fraction of clients whose coalition id flipped since last round."""
    return torch.mean((assignment != prev_assignment).float())


def size_entropy(counts: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (nats) of the coalition-size/mass histogram.

    Zero-mass coalitions contribute 0 (the 0·log 0 limit); an all-empty
    histogram reports 0.0.
    """
    c = torch.clamp(counts.float(), min=0.0)
    p = c / torch.clamp(torch.sum(c), min=_EPS)
    terms = torch.where(p > 0, p * torch.log(torch.clamp(p, min=_EPS)),
                        torch.zeros_like(p))
    return -torch.sum(terms)


def intra_radius(med_d2: torch.Tensor, assignment: torch.Tensor, k: int,
                 client_weights: torch.Tensor | None = None) -> torch.Tensor:
    """(K,) per-coalition RMS member→barycenter distance.

    Reads column j of the (N, K) ``med_d2`` matrix the medoid election
    already has, restricted to coalition j's members and weighted by
    ``client_weights`` (zero-mass clients drop out).  Empty coalitions
    report 0.0.
    """
    ids = torch.arange(k, device=assignment.device, dtype=assignment.dtype)
    member = (assignment[:, None] == ids[None, :]).float()         # (N, K)
    if client_weights is not None:
        member = member * torch.clamp(client_weights.float(), min=0.0)[:, None]
    mass = torch.sum(member, dim=0)                                # (K,)
    mean_d2 = (torch.sum(member * torch.clamp(med_d2, min=0.0), dim=0)
               / torch.clamp(mass, min=_EPS))
    return torch.sqrt(torch.where(mass > 0, mean_d2, torch.zeros_like(mean_d2)))


def barycenter_drift(bary: torch.Tensor, prev_bary: torch.Tensor) -> torch.Tensor:
    """(K,) Euclidean distance each barycenter moved since last round."""
    diff = bary.float() - prev_bary.float()
    return torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=1), min=0.0))
