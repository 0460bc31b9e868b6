"""Plain PyTorch versions of the kernels (the correctness contract).

Each function is the mathematical definition with no tiling: the CPU path of
:mod:`repro_torch.kernels.ops` runs these, and the kernel tests hold the CUDA
kernels against them on the card.  They mirror ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import torch


def pairwise_sq_dists(w: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N, N) squared Euclidean distances, in float32."""
    w = w.float()
    diff = w[:, None, :] - w[None, :, :]
    return torch.sum(diff * diff, dim=-1)


def sq_dists_to_points(w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(N, D), (K, D) -> (N, K) squared distances, in float32."""
    w = w.float()
    p = p.float()
    diff = w[:, None, :] - p[None, :, :]
    return torch.sum(diff * diff, dim=-1)


def segment_sum(mix: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(K, N) one-hot/weights x (N, D) -> (K, D) per-coalition sums."""
    return mix.float() @ w.float()


def center_sq_dists(w: torch.Tensor, conehot: torch.Tensor) -> torch.Tensor:
    """Fused-round pass 1: (N, D), (K, N) center one-hot -> (N, K) sq dists."""
    centers = conehot.float() @ w.float()
    return sq_dists_to_points(w, centers)


def fused_coalition_stats(w: torch.Tensor, m: torch.Tensor,
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused-round pass 2: barycenters b = m @ w, θ = mean(b), medoid d²."""
    b = m.float() @ w.float()
    theta = torch.mean(b, dim=0)
    return b, theta, sq_dists_to_points(w, b)
