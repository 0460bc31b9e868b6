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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None) -> torch.Tensor:
    """Reference multi-head attention with GQA broadcast.

    q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh) with Hq % Hkv == 0.  Queries
    sit at the end of the K/V timeline.  ``window``: a query at position p
    sees keys after p - window.  Returns (B, Hq, Sq, Dh) in q.dtype; softmax
    in float32.  A row that sees no key is NaN here (the kernel writes 0).
    """
    sq, dh = q.shape[2], q.shape[3]
    group = q.shape[1] // k.shape[1]
    skv = k.shape[2]
    if scale is None:
        scale = dh ** -0.5
    kq = torch.repeat_interleave(k, group, dim=1).float()
    vq = torch.repeat_interleave(v, group, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    mask = attention_mask(sq, skv, causal, window, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vq).to(q.dtype)


def attention_mask(sq: int, skv: int, causal: bool, window: int | None,
                   device, kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query sees, queries occupying the
    last Sq slots of the Skv timeline, or with ``kv_len`` (a 0-d tensor:
    a partly filled cache) the Sq slots before position ``kv_len``."""
    end = skv if kv_len is None else kv_len
    qpos = torch.arange(sq, device=device) + (end - sq)
    kpos = torch.arange(skv, device=device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask
