"""Coalition barycenters (paper §III.B) and the medoid center-update step.

``b_j = (1/|C_j|) Σ_{u_i ∈ C_j} ω_i`` — a segment mean over the client weight
matrix, written as a (K, N) one-hot × (N, D) product.  Empty coalitions fall
back to the previous center's weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import backends as bk
from repro_torch.core import distance
from repro_torch.core import fused as fz


def coalition_onehot(assignment: torch.Tensor, k: int) -> torch.Tensor:
    """(K, N) one-hot membership matrix from an (N,) assignment vector."""
    return F.one_hot(assignment.long(), k).T.float()


def barycenters(w: torch.Tensor, assignment: torch.Tensor, k: int, *,
                fallback: torch.Tensor | None = None,
                backend: str | bk.Backend = "stream",
                client_weights: torch.Tensor | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, D) coalition barycenters and (K,) member masses.

    ``fallback``: (K, D) weights used for empty coalitions (previous
    centers).  ``client_weights``: optional (N,) importances — the paper's
    §III.B weighted-average extension; uniform when None.
    """
    onehot = coalition_onehot(assignment, k)                   # (K, N)
    if client_weights is not None:
        onehot = onehot * client_weights.float()[None, :]
    counts = torch.sum(onehot, dim=1)                          # (K,)
    sums = bk.get_backend(backend).segment_sum(onehot, w)      # (K, D)
    # the clamp only dodges 0/0: empty coalitions are replaced below, and
    # fractional masses in (0, 1) must not be shrunk
    b = sums / torch.clamp(counts, min=1e-12)[:, None]
    if fallback is not None:
        b = torch.where((counts == 0)[:, None], fallback.float(), b)
    return b, counts


def medoids(w: torch.Tensor, bary: torch.Tensor, assignment: torch.Tensor, *,
            backend: str | bk.Backend = "stream",
            client_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Step III: new center v_j = argmin over members u_i of d(ω_i, b_j)."""
    d2 = distance.sq_dists_to_points(w, bary, backend=backend)   # (N, K)
    return fz.medoid_from_d2(d2, assignment, client_weights)


def global_aggregate(bary: torch.Tensor) -> torch.Tensor:
    """Paper Step IV: θ = (1/K) Σ_j b_j — unweighted mean of barycenters."""
    return torch.mean(bary, dim=0)
