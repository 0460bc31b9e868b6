"""Coalition-dynamics metrics (pure O(N·K) algebra, no W sweeps).

They turn what the fused round already materializes — the assignment, the
coalition masses, the (N, K) client→barycenter distances and the previous
round's assignment/barycenters — into per-round observables:

  :func:`membership_churn`  — fraction of clients whose coalition flipped.
  :func:`size_entropy`      — Shannon entropy (nats) of the coalition sizes.
  :func:`intra_radius`      — per-coalition RMS member→barycenter distance.
  :func:`barycenter_drift`  — per-coalition ‖b_k(r) − b_k(r−1)‖.
  :func:`quarantine_fraction` — under a byzantine mask, the fraction of
                              adversaries sharing a coalition with an
                              honest client (0.0 = perfect quarantine).
  :func:`contamination`     — honest-mass-weighted bound on how far the
                              adversaries moved the barycenters honest
                              clients sit in, from the same ``med_d2``.

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


def _membership(assignment: torch.Tensor, adversary: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-coalition (member, adversary-mass, honest-mass) from the mask."""
    ids = torch.arange(k, device=assignment.device, dtype=assignment.dtype)
    member = (assignment[:, None] == ids[None, :]).float()         # (N, K)
    adv = torch.clamp(adversary.float(), 0.0, 1.0)                 # (N,)
    a_mass = torch.sum(member * adv[:, None], dim=0)               # (K,)
    h_mass = torch.sum(member * (1.0 - adv)[:, None], dim=0)       # (K,)
    return member, a_mass, h_mass


def quarantine_fraction(assignment: torch.Tensor, adversary: torch.Tensor,
                        k: int) -> torch.Tensor:
    """Fraction of adversaries sharing a coalition with ≥ 1 honest client.

    0.0 is perfect quarantine (or no adversary at all); for flat rules
    (everyone in group 0) it is the indicator that both populations exist.
    """
    _, a_mass, h_mass = _membership(assignment, adversary, k)
    embedded = torch.sum(a_mass * (h_mass > 0))
    total = torch.sum(a_mass)
    return torch.where(total > 0, embedded / torch.clamp(total, min=_EPS),
                       torch.zeros_like(total))


def contamination(med_d2: torch.Tensor, assignment: torch.Tensor,
                  adversary: torch.Tensor, k: int) -> torch.Tensor:
    """Honest-mass-weighted bound on adversary-induced barycenter shift.

    A mixed coalition j with adversary mass a_j and honest mass h_j moves
    its honest clients' model by at most ``(a_j / h_j) · RMS_{i adv in j}
    ‖w_i − b_j‖``, read off column j of ``med_d2`` (no W sweep).  Returns
    the honest-mass-weighted mean of those bounds: 0.0 exactly when every
    coalition is pure.
    """
    member, a_mass, h_mass = _membership(assignment, adversary, k)
    adv = torch.clamp(adversary.float(), 0.0, 1.0)
    adv_d2 = torch.sum(member * adv[:, None] * torch.clamp(med_d2, min=0.0),
                       dim=0)                                      # (K,)
    rms = torch.sqrt(adv_d2 / torch.clamp(a_mass, min=_EPS))
    mixed = (a_mass > 0) & (h_mass > 0)
    bound = torch.where(mixed, (a_mass / torch.clamp(h_mass, min=_EPS)) * rms,
                        torch.zeros_like(rms))
    h_total = torch.sum(h_mass)
    return torch.sum(bound * h_mass) / torch.clamp(h_total, min=_EPS)
