"""Two-pass fused coalition round — Algorithm 1's server step as a streaming
program (the ``Backend.fused_round`` primitive).

At framework scale the round is bound by device-memory bandwidth, so passes
over the (N, D) client weight matrix W are the round time.  Steps II-IV take
two sweeps:

  pass 1 — the (N, K) assignment distances, with the K center rows read out
           of each chunk of W (no (K, D) center gather);
  pass 2 — per chunk: the barycenter tile, its θ tile, and the (N, K)
           client→barycenter distances that elect the medoids.

The empty-coalition fallback (keep the previous center's weights) is folded
into the aggregation matrix: a zero-mass coalition's row becomes the
indicator of its previous center with unit mass, so it is part of the same
product on every backend.

Implementations (registered through :mod:`repro_torch.core.backends`):

  :func:`fused_round_stream`  — two chunked diff-form sweeps in plain PyTorch
                                (the counterpart of the reference's xla).
  :func:`fused_round_dot`     — Gram form: the medoid distances come out of
                                the pass-1 (N, N) Gram matrix.
  :func:`fused_round_cuda`    — the hand-written kernels of
                                :mod:`repro_torch.kernels.fused_round` on
                                CUDA tensors, their plain versions on CPU.
  :func:`compose_fused_round` — the generic composition of the three base
                                primitives, for backends without a fused
                                round.

A non-identity sketcher (:mod:`repro_torch.core.sketch`) moves pass 1 and
the medoid election onto the (N, S) sketch (:func:`sketched_fused_round`):
the sketch is one sweep over W and the barycenter segment sum the only other.

The three fused rounds take a ``reduce`` hook (identity by default), applied
to the pass-1 distances (on ``dot`` the Gram matrix) and to the pass-2
medoid distances: :mod:`repro_torch.core.sharded` runs them on a rank's
column tile of W with ``reduce`` an all-reduce over the mesh, so the dense
and the sharded round are one body.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import backends as bk
from repro_torch.core import instrument
from repro_torch.core import sketch as sk_mod
from repro_torch.kernels import ops as kops
from repro_torch.obs import metrics as obs_metrics


class FusedStats(NamedTuple):
    """What a backend's ``fused_round`` primitive produces (pre-medoid-argmin)."""

    assignment: torch.Tensor   # (N,) int64 coalition id (centers pinned)
    barycenters: torch.Tensor  # (K, D) float32, empty coalitions replaced
    counts: torch.Tensor       # (K,) float32 member mass (pre-fallback)
    med_d2: torch.Tensor       # (N, K) float32 sq dists client -> barycenter
    theta: torch.Tensor        # (D,) float32 mean of the barycenters


class FusedRound(NamedTuple):
    """A full Algorithm-1 round out of :func:`fused_round`."""

    assignment: torch.Tensor      # (N,) int64
    barycenters: torch.Tensor     # (K, D) float32
    counts: torch.Tensor          # (K,) float32
    new_center_idx: torch.Tensor  # (K,) int64 medoid centers v_j^{r+1}
    theta: torch.Tensor           # (D,) float32
    radius: torch.Tensor          # (K,) float32 RMS member->barycenter dist
    med_d2: torch.Tensor          # (N, K) float32


# --- sweep chunk size ------------------------------------------------------------

#: cap on the streaming sweep tile of the plain-PyTorch backends
DEFAULT_CHUNK = 65536


def default_chunk(d: int) -> int:
    """One exact tile for models narrower than the cap, else the cap."""
    return max(1, min(int(d), DEFAULT_CHUNK))


def resolve_chunk(chunk: int | None, d: int) -> int:
    """``chunk`` if set (validated), else :func:`default_chunk`."""
    if chunk is None:
        return default_chunk(d)
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return chunk


# --- shared glue (the O(N*K) algebra between the two passes) ---------------------

def pin_assignment(d2_centers: torch.Tensor,
                   center_idx: torch.Tensor) -> torch.Tensor:
    """Nearest-center argmin with centers pinned to their own coalition."""
    n, k = d2_centers.shape
    a = torch.argmin(d2_centers, dim=1)
    pin = torch.full((n,), -1, dtype=torch.long, device=a.device)
    pin[center_idx.long()] = torch.arange(k, device=a.device)
    return torch.where(pin >= 0, pin, a)


def aggregation_matrix(assignment: torch.Tensor, k: int,
                       center_idx: torch.Tensor,
                       client_weights: torch.Tensor | None = None,
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted membership matrix with the empty-coalition fallback folded in.

    Returns ``(oh_eff, counts, denom)``: a (K, N) matrix whose row j is the
    (client-weighted) membership indicator of coalition j — or, when the
    coalition's mass is zero, the indicator of its previous center with unit
    mass — plus the pre-fallback masses and the barycenter denominators, so
    ``oh_eff @ W / denom[:, None]`` is the whole barycenter step.
    """
    n = assignment.shape[0]
    onehot = F.one_hot(assignment.long(), k).T.float()               # (K, N)
    if client_weights is not None:
        onehot = onehot * client_weights.float()[None, :]
    counts = torch.sum(onehot, dim=1)                                # (K,)
    empty = counts == 0.0
    fallback_rows = F.one_hot(center_idx.long(), n).float()          # (K, N)
    oh_eff = torch.where(empty[:, None], fallback_rows, onehot)
    # far below any real fractional mass, only dodging 0/0 (which the
    # fallback substitution already avoids)
    denom = torch.where(empty, torch.ones_like(counts),
                        torch.clamp(counts, min=1e-12))
    return oh_eff, counts, denom


def medoid_from_d2(med_d2: torch.Tensor, assignment: torch.Tensor,
                   client_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Step III center update from the client->barycenter distances.

    Restricted to members of each coalition with positive mass; falls back
    to the global argmin when a coalition has no positive-mass member.
    """
    k = med_d2.shape[1]
    ids = torch.arange(k, device=assignment.device)
    member = assignment[:, None] == ids[None, :]                     # (N, K)
    if client_weights is not None:
        member = member & (client_weights > 0)[:, None]
    masked = torch.where(member, med_d2, torch.full_like(med_d2, float("inf")))
    any_member = torch.any(member, dim=0)
    return torch.where(any_member, torch.argmin(masked, dim=0),
                       torch.argmin(med_d2, dim=0))


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


Reduce = Callable[[torch.Tensor], torch.Tensor]


# --- stream: chunked diff form in plain PyTorch ---------------------------------

def _stream_center_d2(w: torch.Tensor, center_idx: torch.Tensor,
                      chunk: int) -> torch.Tensor:
    """Pass 1: (N, K) assignment distances, center rows read out of each chunk."""
    n, d = w.shape
    acc = torch.zeros((n, center_idx.shape[0]), dtype=torch.float32,
                      device=w.device)
    for start in range(0, d, chunk):
        wk = w[:, start:start + chunk].float()
        diff = wk[:, None, :] - wk[center_idx][None, :, :]
        acc += torch.sum(diff * diff, dim=-1)
    return acc


def _stream_bary_med_theta(w: torch.Tensor, oh_eff: torch.Tensor,
                           denom: torch.Tensor, chunk: int,
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 2: barycenter + θ tiles written per chunk, medoid d² accumulated."""
    n, d = w.shape
    k = oh_eff.shape[0]
    b = torch.empty((k, d), dtype=torch.float32, device=w.device)
    theta = torch.empty((d,), dtype=torch.float32, device=w.device)
    acc = torch.zeros((n, k), dtype=torch.float32, device=w.device)
    for start in range(0, d, chunk):
        wk = w[:, start:start + chunk].float()
        bc = (oh_eff @ wk) / denom[:, None]                          # (K, c)
        b[:, start:start + chunk] = bc
        theta[start:start + chunk] = torch.mean(bc, dim=0)
        diff = wk[:, None, :] - bc[None, :, :]
        acc += torch.sum(diff * diff, dim=-1)
    return b, theta, acc


def fused_round_stream(w: torch.Tensor, center_idx: torch.Tensor, *,
                       client_weights: torch.Tensor | None = None,
                       chunk: int | None = None,
                       reduce: Reduce = _identity) -> FusedStats:
    """Two chunked diff-form sweeps over W in plain PyTorch, ``chunk``
    columns at a time (:func:`resolve_chunk`); ``reduce`` as in the module
    docstring."""
    k = center_idx.shape[0]
    chunk = resolve_chunk(chunk, w.shape[1])
    instrument.count_w_pass()                                # pass 1
    d2c = reduce(_stream_center_d2(w, center_idx, chunk))
    assignment = pin_assignment(d2c, center_idx)
    oh_eff, counts, denom = aggregation_matrix(assignment, k, center_idx,
                                               client_weights)
    instrument.count_w_pass()                                # pass 2
    b, theta, med_d2 = _stream_bary_med_theta(w, oh_eff, denom, chunk)
    return FusedStats(assignment=assignment, barycenters=b, counts=counts,
                      med_d2=reduce(med_d2), theta=theta)


# --- dot: Gram composition -------------------------------------------------------

def fused_round_dot(w: torch.Tensor, center_idx: torch.Tensor, *,
                    client_weights: torch.Tensor | None = None,
                    chunk: int | None = None,
                    reduce: Reduce = _identity) -> FusedStats:
    """Gram form: the medoid distances are Gram algebra,
    ⟨w_i, b_j⟩ = (G · oh_effᵀ)_ij / denom_j, so only the barycenter product
    re-reads W.  Its two products are whole, so ``chunk`` is ignored, as in
    the reference.  ``reduce`` applies to the Gram matrix alone: the medoid
    distances come out of the reduced one."""
    k = center_idx.shape[0]
    wf = w.float()
    instrument.count_w_pass()                                # pass 1
    gram = reduce(wf @ wf.T)                                 # (N, N)
    sq = torch.diagonal(gram)
    d2c = torch.clamp(sq[:, None] + sq[center_idx][None, :]
                      - 2.0 * gram[:, center_idx], min=0.0)
    assignment = pin_assignment(d2c, center_idx)
    oh_eff, counts, denom = aggregation_matrix(assignment, k, center_idx,
                                               client_weights)
    instrument.count_w_pass()                                # pass 2
    b = (oh_eff @ wf) / denom[:, None]
    theta = torch.mean(b, dim=0)
    cross = (gram @ oh_eff.T) / denom[None, :]               # (N, K)
    bsq = torch.diagonal(oh_eff @ gram @ oh_eff.T) / (denom * denom)
    med_d2 = torch.clamp(sq[:, None] + bsq[None, :] - 2.0 * cross, min=0.0)
    return FusedStats(assignment=assignment, barycenters=b, counts=counts,
                      med_d2=med_d2, theta=theta)


# --- cuda: the hand-written kernels -----------------------------------------------

def fused_round_cuda(w: torch.Tensor, center_idx: torch.Tensor, *,
                     client_weights: torch.Tensor | None = None,
                     chunk: int | None = None,
                     reduce: Reduce = _identity) -> FusedStats:
    """Both passes through :mod:`repro_torch.kernels.ops`: the CUDA kernels
    for a CUDA W, their plain versions for a CPU W.  The kernels sweep D in
    their own tiles, so ``chunk`` is ignored, as the reference's Pallas
    round does; ``reduce`` as in the module docstring."""
    n = w.shape[0]
    k = center_idx.shape[0]
    conehot = F.one_hot(center_idx.long(), n).float()        # (K, N)
    instrument.count_w_pass()                                # pass 1
    d2c = reduce(kops.center_sq_dists(w, conehot))
    assignment = pin_assignment(d2c, center_idx)
    oh_eff, counts, denom = aggregation_matrix(assignment, k, center_idx,
                                               client_weights)
    instrument.count_w_pass()                                # pass 2
    b, theta, med_d2 = kops.fused_coalition_stats(
        w, (oh_eff / denom[:, None]).contiguous())
    return FusedStats(assignment=assignment, barycenters=b, counts=counts,
                      med_d2=reduce(med_d2), theta=theta)


# --- generic composition ---------------------------------------------------------

def compose_fused_round(backend: bk.Backend, w: torch.Tensor,
                        center_idx: torch.Tensor, *,
                        client_weights: torch.Tensor | None = None,
                        chunk: int | None = None) -> FusedStats:
    """The round from the three base primitives only: one center gather plus
    three primitive calls, with the fallback folded into the segment sum."""
    k = center_idx.shape[0]
    centers = w[center_idx]
    d2c = backend.sq_dists_to_points(w, centers, chunk=chunk)
    assignment = pin_assignment(d2c, center_idx)
    oh_eff, counts, denom = aggregation_matrix(assignment, k, center_idx,
                                               client_weights)
    b = backend.segment_sum(oh_eff, w) / denom[:, None]
    theta = torch.mean(b, dim=0)
    med_d2 = backend.sq_dists_to_points(w, b, chunk=chunk)
    return FusedStats(assignment=assignment, barycenters=b, counts=counts,
                      med_d2=med_d2, theta=theta)


# --- sketched round (assignment + medoids in sketch space) ------------------------

def sketch_stage(backend: bk.Backend, s_w: torch.Tensor,
                 center_idx: torch.Tensor, *,
                 client_weights: torch.Tensor | None = None):
    """Pass 1 and the medoid geometry entirely on the (N, S) sketch.

    The sketch map is linear, so ``(oh_eff @ s_w) / denom`` is the exact
    sketch of the true barycenters and the medoid-electing distances are JL
    estimates; nothing here touches full W.  The backend's distance
    primitives run on the sketch under :func:`instrument.suspend_w_passes`.

    Returns ``(assignment, oh_eff, counts, denom, med_d2)``.
    """
    k = center_idx.shape[0]
    with instrument.suspend_w_passes():
        d2c = backend.sq_dists_to_points(s_w, s_w[center_idx])
        assignment = pin_assignment(d2c, center_idx)
        oh_eff, counts, denom = aggregation_matrix(assignment, k, center_idx,
                                                   client_weights)
        s_b = (oh_eff @ s_w.float()) / denom[:, None]               # (K, S)
        med_d2 = backend.sq_dists_to_points(s_w, s_b)
    return assignment, oh_eff, counts, denom, med_d2


def sketched_fused_round(backend: bk.Backend, w: torch.Tensor,
                         s_w: torch.Tensor, center_idx: torch.Tensor, *,
                         client_weights: torch.Tensor | None = None,
                         sketch_backend: bk.Backend | None = None,
                         ) -> FusedStats:
    """One coalition round given the sketch ``s_w``: ONE full sweep over W,
    the barycenter segment sum (which counts its own pass).
    ``sketch_backend`` runs the distances on the sketch (default
    ``backend``; the sharded round takes the plain ``stream`` ones, as the
    reference's does)."""
    assignment, oh_eff, counts, denom, med_d2 = sketch_stage(
        sketch_backend or backend, s_w, center_idx,
        client_weights=client_weights)
    b = backend.segment_sum(oh_eff, w) / denom[:, None]
    theta = torch.mean(b, dim=0)
    return FusedStats(assignment=assignment, barycenters=b, counts=counts,
                      med_d2=med_d2, theta=theta)


# --- dispatcher ------------------------------------------------------------------

def fused_round(w: torch.Tensor, center_idx: torch.Tensor, *,
                client_weights: torch.Tensor | None = None,
                backend: str | bk.Backend = "stream",
                sketcher: sk_mod.Sketcher | None = None,
                chunk: int | None = None) -> FusedRound:
    """One fused Algorithm-1 round (Steps II-IV) over client weights ``w``.

    Runs ``backend.fused_round`` when the backend has one, else
    :func:`compose_fused_round`; a non-identity ``sketcher`` runs the
    backend's ``sketched_fused_round`` where it has one (the sharded
    backends, which sum partial sketches of their tiles), else
    :func:`sketched_fused_round` on the dense sketch of W (2 W sweeps
    either way).  ``chunk`` is the streaming sweeps' column tile
    (:func:`resolve_chunk`).  Finishes with the shared medoid argmin and
    the intra radius, both O(N·K) algebra over ``med_d2``.
    """
    backend = bk.get_backend(backend)
    if sketcher is not None and not sketcher.is_identity:
        if backend.sketched_fused_round is not None:
            s = backend.sketched_fused_round(
                w, center_idx, client_weights=client_weights,
                sketcher=sketcher, chunk=chunk)
        else:
            s_w = sk_mod.sketch_matrix(sketcher, w)
            s = sketched_fused_round(backend, w, s_w, center_idx,
                                     client_weights=client_weights)
    else:
        impl = (backend.fused_round if backend.fused_round is not None
                else functools.partial(compose_fused_round, backend))
        s = impl(w, center_idx, client_weights=client_weights, chunk=chunk)
    new_center_idx = medoid_from_d2(s.med_d2, s.assignment, client_weights)
    radius = obs_metrics.intra_radius(s.med_d2, s.assignment,
                                      center_idx.shape[0], client_weights)
    return FusedRound(assignment=s.assignment, barycenters=s.barycenters,
                      counts=s.counts, new_center_idx=new_center_idx,
                      theta=s.theta, radius=radius, med_d2=s.med_d2)
