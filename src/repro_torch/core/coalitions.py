"""Algorithm 1 — Federated Learning with Coalition Formation based on
Euclidean Distance between Weights (paper §III.C).

  Step I   ``init_centers``      — K random distinct clients (pairwise d > 0)
  Step II  ``assign``            — nearest-center assignment (centers keep
                                   their own coalition)
  Step III ``barycenters`` +     — segment mean, then medoid center update
           ``medoids``
  Step IV  ``global_aggregate``  — θ = mean of coalition barycenters

Steps II-IV default to the backend's two-pass ``fused_round``
(:mod:`repro_torch.core.fused`); ``run_round(..., fused=False)`` keeps the
composed path of separate primitive calls (three W sweeps: assignment,
barycenter segment sum, medoid distances).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import backends as bk
from repro_torch.core import barycenter as bary_mod
from repro_torch.core import distance
from repro_torch.core import fused as fz
from repro_torch.obs import metrics as obs_metrics


class CoalitionState(NamedTuple):
    """Per-round coalition bookkeeping."""

    center_idx: torch.Tensor  # (K,) int64 indices v_j^r of the center clients
    round: int


class CoalitionRound(NamedTuple):
    """Everything Algorithm 1 produces in one global round."""

    assignment: torch.Tensor      # (N,) int64 coalition id per client
    barycenters: torch.Tensor     # (K, D) float32 b_j^r
    counts: torch.Tensor          # (K,) member masses |C_j|
    new_center_idx: torch.Tensor  # (K,) int64 v_j^{r+1}
    theta: torch.Tensor           # (D,) float32 global model θ^{(r)}
    radius: torch.Tensor          # (K,) float32 RMS member->barycenter dist
    med_d2: torch.Tensor          # (N, K) float32 client->barycenter sq dists
    state: CoalitionState


def init_centers(w: torch.Tensor, k: int, *, perm: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> CoalitionState:
    """Step I: choose K random distinct clients as initial centers.

    Walks a random permutation of the clients and greedily accepts a client
    whose weights differ from every center accepted so far (the paper's
    rejection rule, made total: the first K of the permutation if fewer
    than K distinct weight vectors exist).  ``perm`` injects the permutation
    (tests pass the reference's draw); otherwise it is drawn from
    ``generator``.
    """
    n = w.shape[0]
    if perm is None:
        perm = torch.randperm(n, generator=generator)
    perm = perm.tolist() if torch.is_tensor(perm) else np.asarray(perm).tolist()
    d2 = distance.pairwise_sq_dists(w).cpu()                  # (N, N)
    sel: list[int] = []
    for cand in perm:
        if len(sel) == k:
            break
        if all(float(d2[cand, s]) > 0.0 for s in sel):
            sel.append(cand)
    if len(sel) < k:
        sel = perm[:k]
    return CoalitionState(
        center_idx=torch.tensor(sel, dtype=torch.long, device=w.device),
        round=0)


def assign(w: torch.Tensor, center_idx: torch.Tensor, *,
           backend: str | bk.Backend = "stream",
           chunk: int | None = None) -> torch.Tensor:
    """Step II: each client joins the coalition with the nearest center."""
    d2 = distance.sq_dists_to_points(w, w[center_idx], backend=backend,
                                     chunk=chunk)             # (N, K)
    return fz.pin_assignment(d2, center_idx)


def run_round(w: torch.Tensor, state: CoalitionState, *,
              backend: str | bk.Backend = "stream",
              client_weights: torch.Tensor | None = None,
              fused: bool = True,
              chunk: int | None = None,
              sketcher=None) -> CoalitionRound:
    """One full Algorithm-1 server round over fresh client weights ``w``.

    ``client_weights``: optional (N,) importances (uniform = the paper's
    Algorithm 1); zero-weight clients cannot be elected medoid.
    ``fused=True`` runs Steps II-IV through the backend's two-pass
    ``fused_round``; ``fused=False`` runs the composed path.  ``chunk``:
    the streaming sweeps' column tile (None = the size-derived default,
    :func:`repro_torch.core.fused.resolve_chunk`), the same on both.  A non-identity
    ``sketcher`` (:mod:`repro_torch.core.sketch`) runs assignment and medoid
    election on the (N, S) sketch, through the fused entry point whatever
    ``fused`` says (the composed path has no sketched form).
    """
    backend = bk.get_backend(backend)
    k = state.center_idx.shape[0]
    if sketcher is not None and not sketcher.is_identity:
        fused = True                 # a sketch has only the fused entry point
    if fused:
        r = fz.fused_round(w, state.center_idx, backend=backend,
                           client_weights=client_weights, chunk=chunk,
                           sketcher=sketcher)
        return CoalitionRound(
            assignment=r.assignment, barycenters=r.barycenters,
            counts=r.counts, new_center_idx=r.new_center_idx, theta=r.theta,
            radius=r.radius, med_d2=r.med_d2,
            state=CoalitionState(center_idx=r.new_center_idx,
                                 round=state.round + 1))
    assignment = assign(w, state.center_idx, backend=backend, chunk=chunk)
    b, counts = bary_mod.barycenters(
        w, assignment, k, fallback=w[state.center_idx].float(),
        backend=backend, client_weights=client_weights)
    # the medoid election and the intra radius share one distance matrix
    med_d2 = distance.sq_dists_to_points(w, b, backend=backend, chunk=chunk)
    new_centers = fz.medoid_from_d2(med_d2, assignment, client_weights)
    radius = obs_metrics.intra_radius(med_d2, assignment, k, client_weights)
    return CoalitionRound(
        assignment=assignment, barycenters=b, counts=counts,
        new_center_idx=new_centers, theta=bary_mod.global_aggregate(b),
        radius=radius, med_d2=med_d2,
        state=CoalitionState(center_idx=new_centers, round=state.round + 1))
