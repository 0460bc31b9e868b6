"""Device dispatch for the kernels.

A CUDA tensor goes to the hand-written kernel, whose wrapper raises if the
build or the launch fails; a CPU tensor goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_round, ref


def _on_card(w: torch.Tensor) -> bool:
    if w.device.type == "cuda":
        return True
    if w.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {w.device}")


def center_sq_dists(w: torch.Tensor, conehot: torch.Tensor) -> torch.Tensor:
    """Fused-round pass 1: (N, D), (K, N) -> (N, K) squared distances."""
    if _on_card(w):
        return fused_round.center_sq_dists(w, conehot)
    return ref.center_sq_dists(w, conehot)


def fused_coalition_stats(w: torch.Tensor, m: torch.Tensor):
    """Fused-round pass 2: (N, D), (K, N) -> b (K, D), θ (D,), (N, K)."""
    if _on_card(w):
        return fused_round.fused_coalition_stats(w, m)
    return ref.fused_coalition_stats(w, m)
