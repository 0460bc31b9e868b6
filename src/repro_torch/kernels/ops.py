"""Device dispatch for the kernels.

A CUDA tensor goes to the hand-written kernel, whose wrapper raises if the
build or the launch fails; a CPU tensor goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`.  There is no fallback from one to the other.
:func:`flash_attention` is differentiable: kernel forward, and the gradient
of the plain version as its backward, as the reference's ``custom_vjp``.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import is_traceable_wrapper_subclass

from repro_torch.kernels import (conv_pool, flash_attention as _fa,
                                 fused_round, pairwise_dist, ref,
                                 segment_mean)

_WRAPPERS = (fused_round, pairwise_dist, segment_mean, _fa, conv_pool)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for mod in _WRAPPERS:
        mod.reset_launch_counts()


def launch_counts() -> dict[str, int]:
    """Launches of every kernel in this process, by kernel name."""
    return {name: n for mod in _WRAPPERS for name, n in mod.LAUNCHES.items()}


def _on_card(w: torch.Tensor) -> bool:
    if isinstance(w, FakeTensor) or is_traceable_wrapper_subclass(w):
        # a kernel reads real memory through data_ptr: a fake tensor (the
        # dry-run's) or a DTensor has none to give it
        raise ValueError(f"no kernel for a {type(w).__name__}: the kernels "
                         "take plain tensors with storage (trace the plain "
                         "versions instead)")
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


def pairwise_sq_dists(w: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N, N) squared distances, clamped at 0, zero diagonal."""
    if _on_card(w):
        return pairwise_dist.pairwise_sq_dists(w)
    return ref.pairwise_sq_dists(w)


def sq_dists_to_points(w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(N, D), (K, D) -> (N, K) squared distances, clamped at 0."""
    if _on_card(w):
        return pairwise_dist.sq_dists_to_points(w, p)
    return ref.sq_dists_to_points(w, p)


def segment_sum(mix: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(K, N) @ (N, D) -> (K, D) coalition sums."""
    if _on_card(w):
        return segment_mean.segment_sum(mix, w)
    return ref.segment_sum(mix, w)


class _FlashAttention(torch.autograd.Function):
    """Kernel forward; the backward recomputes the plain version and takes
    its gradient (the reference has no backward kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale)
        if _on_card(q):
            return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                       scale=scale)
        return ref.attention(q, k, v, causal=causal, window=window,
                             scale=scale)

    @staticmethod
    def backward(ctx, g):
        causal, window, scale = ctx.args
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.attention(*inputs, causal=causal, window=window,
                                scale=scale)
        return (*torch.autograd.grad(out, inputs, g), None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention, q (B, Hq, Sq, Dh), k and v (B, Hkv, Skv, Dh) -> (B, Hq,
    Sq, Dh) in q's dtype: the kernel forward on the card, the plain version
    on the CPU; differentiable in q, k and v through the plain version."""
    return _FlashAttention.apply(q, k, v, causal, window, scale)
