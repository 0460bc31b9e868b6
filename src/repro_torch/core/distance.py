"""Euclidean distance between model weights (paper §III.A).

``d(ω1, ω2) = sqrt(Σ_i (ω1_i − ω2_i)^2)``

The (N, D) weight matrix is never expanded to an (N, N, D) difference: the
``stream`` backend accumulates chunked partial sums over D.  Registered here:

  ``'stream'`` — exact chunked diff form (the reference's ``xla``)
  ``'dot'``    — Gram form ‖wi‖² + ‖wj‖² − 2⟨wi, wj⟩

including their ``segment_sum`` barycenter reduction (a one-hot product);
``'cuda'`` (the hand-written kernels) is registered by ``backends.py``.
The public functions resolve whichever name or
:class:`~repro_torch.core.backends.Backend` the caller passes.
"""
from __future__ import annotations

import torch

from repro_torch.core import backends as bk
from repro_torch.core import fused as fz
from repro_torch.core import instrument


def _pairwise_sq_stream(w: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked Σ_d (w[i,d]-w[j,d])^2 -> (N, N)."""
    instrument.count_w_pass()
    n, d = w.shape
    acc = torch.zeros((n, n), dtype=torch.float32, device=w.device)
    for start in range(0, d, chunk):
        wk = w[:, start:start + chunk].float()
        diff = wk[:, None, :] - wk[None, :, :]
        acc += torch.sum(diff * diff, dim=-1)
    return acc


def _pairwise_sq_dot(w: torch.Tensor, chunk: int | None = None
                     ) -> torch.Tensor:
    """Gram form, clamped at 0 with the diagonal zeroed (one product: the
    chunk hint is ignored)."""
    instrument.count_w_pass()
    wf = w.float()
    gram = wf @ wf.T
    sq = torch.sum(wf * wf, dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * gram, min=0.0)
    return d2.fill_diagonal_(0.0)


def _to_points_sq_stream(w: torch.Tensor, points: torch.Tensor,
                         chunk: int) -> torch.Tensor:
    instrument.count_w_pass()
    n, d = w.shape
    acc = torch.zeros((n, points.shape[0]), dtype=torch.float32,
                      device=w.device)
    for start in range(0, d, chunk):
        wk = w[:, start:start + chunk].float()
        pk = points[:, start:start + chunk].float()
        diff = wk[:, None, :] - pk[None, :, :]
        acc += torch.sum(diff * diff, dim=-1)
    return acc


def _to_points_sq_dot(w: torch.Tensor, points: torch.Tensor,
                      chunk: int | None = None) -> torch.Tensor:
    instrument.count_w_pass()
    wf, pf = w.float(), points.float()
    d2 = (torch.sum(wf * wf, dim=1)[:, None] + torch.sum(pf * pf, dim=1)[None, :]
          - 2.0 * (wf @ pf.T))
    return torch.clamp(d2, min=0.0)


def _segment_sum_matmul(onehot: torch.Tensor, w: torch.Tensor,
                        chunk: int | None = None) -> torch.Tensor:
    """(K, N) one-hot × (N, D) weights -> (K, D) per-coalition sums (one
    product: the chunk hint is ignored)."""
    instrument.count_w_pass()
    return onehot.float() @ w.float()


bk.register_backend(bk.Backend(
    name="stream",
    pairwise_sq_dists=lambda w, chunk=None: _pairwise_sq_stream(
        w, fz.resolve_chunk(chunk, w.shape[1])),
    sq_dists_to_points=lambda w, p, chunk=None: _to_points_sq_stream(
        w, p, fz.resolve_chunk(chunk, w.shape[1])),
    segment_sum=_segment_sum_matmul,
    fused_round=fz.fused_round_stream,
))

bk.register_backend(bk.Backend(
    name="dot",
    pairwise_sq_dists=_pairwise_sq_dot,
    sq_dists_to_points=_to_points_sq_dot,
    segment_sum=_segment_sum_matmul,
    fused_round=fz.fused_round_dot,
))


def pairwise_sq_dists(w: torch.Tensor, *,
                      backend: str | bk.Backend = "stream") -> torch.Tensor:
    """(N, N) float32 squared pairwise distances of the rows of ``w``."""
    return bk.get_backend(backend).pairwise_sq_dists(w)


def pairwise_dists(w: torch.Tensor, *,
                   backend: str | bk.Backend = "stream") -> torch.Tensor:
    """The paper's d(ω_i, ω_j): element-wise sqrt of the squared distances."""
    return torch.sqrt(torch.clamp(pairwise_sq_dists(w, backend=backend),
                                  min=0.0))


def sq_dists_to_points(w: torch.Tensor, points: torch.Tensor, *,
                       backend: str | bk.Backend = "stream",
                       chunk: int | None = None) -> torch.Tensor:
    """(N, K) squared distances from each client row to each point row
    (``chunk``: the streaming sweep's column tile)."""
    return bk.get_backend(backend).sq_dists_to_points(w, points, chunk=chunk)


def dists_to_points(w: torch.Tensor, points: torch.Tensor, *,
                    backend: str | bk.Backend = "stream") -> torch.Tensor:
    """(N, K) distances: element-wise sqrt of :func:`sq_dists_to_points`."""
    return torch.sqrt(torch.clamp(
        sq_dists_to_points(w, points, backend=backend), min=0.0))
