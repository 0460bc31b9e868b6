"""Aggregation rules + communication accounting (mirrors
``repro.core.aggregation``).

``fedavg``              — the paper's baseline (uniform client mean; the
                          paper gives every client an equal-size shard, so
                          the n_k/n weighting degenerates to 1/N).
``fedavg_masked``       — the same under per-client participation/staleness
                          weights (the ``semi_async`` engine's mask).
``trimmed_mean``        — coordinate-wise trimmed mean (robust-aggregation
                          family; the ``fedavg_trimmed`` rule).
``trimmed_mean_masked`` — the same over the *present* rows only, so absent
                          clients cannot occupy trim slots.
``coalition_round``     — the paper's proposed rule (mean of coalition
                          barycenters, Algorithm 1).
``CommModel``           — bytes a round moves: flat (every client <-> server)
                          against hierarchical (clients <-> coalition head,
                          heads <-> server).

All of it is plain PyTorch: the reference computes these outside any Pallas
kernel (``jnp.mean``, ``jnp.sort`` and elementwise algebra).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import backends as bk
from repro_torch.core import coalitions as co


def fedavg(w: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """FedAvg over the (N, D) client weight matrix.

    Args:
      weights: optional (N,) non-negative client weights (e.g. shard sizes);
        uniform if None.
    """
    if weights is None:
        return torch.mean(w.float(), dim=0)
    wts = weights.float()
    wts = wts / torch.sum(wts)
    return wts @ w.float()


def fedavg_masked(w: torch.Tensor, mask: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Participation-weighted FedAvg: ``Σ_i c_i m_i ω_i / Σ_i c_i m_i``.

    ``mask`` is the (N,) participation/staleness weight (1 = delivered this
    round, decayed for a late update, 0 = excluded); ``weights`` optional
    base client weights.  The denominator is clamped, so an all-zero mask
    gives θ = 0, not NaN.

    The uniform path is the mean of mask-rescaled rows, so an all-ones mask
    is bit-identical to :func:`fedavg`: the rescale ``N / Σm`` is then
    exactly 1.0 and the surviving op is the same ``mean``.  The weighted
    path mirrors :func:`fedavg`'s normalise-then-dot for the same reason.
    """
    m = mask.float()
    if weights is None:
        scale = m.shape[0] / torch.clamp(torch.sum(m), min=1e-12)
        return torch.mean(w.float() * (m * scale)[:, None], dim=0)
    eff = weights.float() * m
    eff = eff / torch.clamp(torch.sum(eff), min=1e-12)
    return eff @ w.float()


def _check_trim(trim: int, n: int) -> None:
    if not 0 <= 2 * trim < n:
        raise ValueError(f"trim={trim} must satisfy 0 <= 2*trim < n={n}")


def trimmed_mean(w: torch.Tensor, trim: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean over the (N, D) client weight matrix:
    drop the ``trim`` largest and smallest values of each parameter, average
    the rest.  ``trim=0`` is exactly uniform FedAvg."""
    n = w.shape[0]
    _check_trim(trim, n)
    if trim == 0:
        return fedavg(w)
    ws = torch.sort(w.float(), dim=0).values
    return torch.mean(ws[trim:n - trim], dim=0)


def trimmed_mean_masked(w: torch.Tensor, trim: int,
                        mask: torch.Tensor) -> torch.Tensor:
    """Trimmed mean over the *present* rows (mask strictly positive).

    Absent rows become ``+inf`` so they sort last and are never kept;
    ``trim`` is clamped to what the effective row count ``n_eff`` affords
    (``2*t < n_eff``) and the mean runs over the surviving window.  An
    all-present mask keeps :func:`trimmed_mean`'s window; an all-absent
    mask gives zeros.  ``n_eff`` stays a tensor on W's device (no host
    sync).
    """
    n = w.shape[0]
    _check_trim(trim, n)
    present = mask.float() > 0.0
    ws = torch.sort(torch.where(present[:, None], w.float(),
                                torch.tensor(float("inf"), device=w.device)),
                    dim=0).values
    n_eff = torch.sum(present.to(torch.int32))
    t = torch.clamp(torch.clamp(n_eff - 1, min=0) // 2, max=trim)
    pos = torch.arange(n, dtype=torch.int32, device=w.device)[:, None]
    keep = (pos >= t) & (pos < n_eff - t)
    denom = torch.clamp(n_eff - 2 * t, min=1).float()
    return torch.sum(torch.where(keep, ws, torch.zeros_like(ws)),
                     dim=0) / denom


def coalition_round(w: torch.Tensor, state: co.CoalitionState, *,
                    backend: str | bk.Backend = "stream") -> co.CoalitionRound:
    return co.run_round(w, state, backend=backend)


class CommModel(NamedTuple):
    """Bytes moved per global round for a model of ``d`` parameters."""

    wan_up: int       # client/head -> server bytes over the constrained link
    wan_down: int     # server -> client/head bytes
    edge_up: int      # client -> coalition-head bytes (local/cheap link)
    edge_down: int


def _check_comm_args(n_clients: int, d: int, bytes_per_param: int,
                     k: int | None = None) -> None:
    if n_clients < 1:
        raise ValueError(f"n_clients={n_clients} must be >= 1")
    if d < 1:
        raise ValueError(f"d={d} must be >= 1")
    if bytes_per_param < 1:
        raise ValueError(f"bytes_per_param={bytes_per_param} must be >= 1")
    if k is not None and not 1 <= k <= n_clients:
        raise ValueError(
            f"k={k} coalitions must satisfy 1 <= k <= n_clients={n_clients}")


def comm_fedavg(n_clients: int, d: int, bytes_per_param: int = 4) -> CommModel:
    """Flat FedAvg: every client uploads its full model to the server."""
    _check_comm_args(n_clients, d, bytes_per_param)
    m = d * bytes_per_param
    return CommModel(wan_up=n_clients * m, wan_down=n_clients * m,
                     edge_up=0, edge_down=0)


def comm_coalition(n_clients: int, k: int, d: int,
                   bytes_per_param: int = 4) -> CommModel:
    """Hierarchical coalition schedule: members reach their coalition head
    over the edge link and only the K barycenters cross the WAN, so the WAN
    uplink shrinks by N/K."""
    _check_comm_args(n_clients, d, bytes_per_param, k=k)
    m = d * bytes_per_param
    return CommModel(wan_up=k * m, wan_down=k * m,
                     edge_up=n_clients * m, edge_down=n_clients * m)


def wan_savings(n_clients: int, k: int) -> float:
    """Multiplicative WAN-uplink saving of the coalition schedule vs FedAvg."""
    _check_comm_args(n_clients, d=1, bytes_per_param=1, k=k)
    return n_clients / k
