"""Mixture-of-Experts layer: token-choice top-k routing with sort-based,
capacity-bounded dispatch, as ``repro.models.moe`` computes it on one
device (its ``_moe_apply_gspmd``).

Dispatch: flatten the (token, choice) pairs, argsort them stably by expert
id, give each pair its slot within its expert from the exclusive cumsum of
the expert counts, drop the pairs beyond the capacity
C = max(ceil(cf * T * top_k / E), 4), gather the tokens into an (E, C, d)
buffer, run the batched SwiGLU expert FFN over it (``torch.bmm``; the
reference runs these products in XLA, outside any Pallas kernel), and
sum each token's gated outputs.  Which pairs are kept is part of the
result: the stable sort keeps, within an expert, the pairs in (token,
choice) order, so the later tokens are the ones dropped.

Returns the Switch-style load-balance auxiliary loss alongside the output.
The expert stacks keep the reference's (E, d_in, d_out) layout, the one
``torch.bmm`` takes; the router is a dense (E, d) weight in f32.  Expert
parallelism (``moe_apply_ep``) waits for the sharding slice (ROADMAP queue
A.6).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, dtype_of

Params = Mapping[str, torch.Tensor]


def moe_init(generator: torch.Generator, cfg: ModelConfig,
             device: str | torch.device = "cpu") -> dict:
    """The router (E, d) in f32 and the SwiGLU expert stacks (E, d_in,
    d_out) in the config's dtype, N(0, 1) * d_in ** -0.5."""
    dt = dtype_of(cfg)
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def experts(d_in, d_out):
        w = torch.randn((e, d_in, d_out), generator=generator,
                        device=generator.device) * d_in ** -0.5
        return w.to(device=device, dtype=dt)

    return {
        "router": dense_init(generator, d, e, torch.float32, device=device),
        "wi_gate": experts(d, ff),
        "wi_up": experts(d, ff),
        "wo": experts(ff, d),
    }


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert: ceil(cf * T * top_k / E), at least 4 (the
    reference's float expression, so the rounding is the same)."""
    c = int(-(-cfg.capacity_factor * n_tokens * cfg.top_k // cfg.n_experts))
    return max(c, 4)


class Dispatch(NamedTuple):
    """Where the (token, choice) pairs go, in expert-sorted order: ``order``
    (T*K,) the pair index of each sorted entry, ``slot`` (T*K,) its row of
    the flat (E * C, d) buffer (E * C where dropped), ``keep`` (T*K,)
    bool, ``gates`` (T*K,) its renormalised gate, ``counts`` (E,) the pairs
    routed to each expert, ``probs`` (T, E) the router's softmax."""

    order: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gates: torch.Tensor
    counts: torch.Tensor
    probs: torch.Tensor


def dispatch(params: Params, cfg: ModelConfig, xt: torch.Tensor,
             cap: int) -> Dispatch:
    """Route the tokens xt (T, d): softmax of the f32 router, top-k, gates
    renormalised, then the stable sort by expert id and the slots."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    logits = F.linear(xt.float(), params["router"])            # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)       # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    flat_e = expert_idx.reshape(-1)                            # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=e)               # (E,)
    starts = torch.cumsum(counts, 0) - counts                  # exclusive
    pos = torch.arange(t * k, device=xt.device) - starts[sorted_e]
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos,
                       torch.full_like(pos, e * cap))
    return Dispatch(order, slot, keep, gate_vals.reshape(-1)[order], counts,
                    probs)


def moe_apply(params: Params, cfg: ModelConfig,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux load-balance loss (), f32)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    xt = x.reshape(t, d)
    route = dispatch(params, cfg, xt, cap)
    src_token = route.order // k                               # (T*K,)

    # the buffer's extra last row takes the dropped pairs
    keep = route.keep[:, None]
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[route.slot] = torch.where(keep, xt[src_token], 0.0)
    buf = buf[:e * cap].reshape(e, cap, d)

    h_gate = torch.bmm(buf, params["wi_gate"])                 # (E, C, ff)
    h_up = torch.bmm(buf, params["wi_up"])
    h = F.silu(h_gate.float()).to(x.dtype) * h_up
    out_e = torch.bmm(h, params["wo"])                         # (E, C, d)

    # combine: each pair's gated output back at its (token, choice) row,
    # then the sum over the choices (in f32 for bf16, rounded once; no
    # scatter-add, so the sum's order is fixed)
    out_flat = out_e.reshape(e * cap, d)
    gathered = torch.where(
        keep, out_flat[torch.clamp(route.slot, max=e * cap - 1)], 0.0)
    pairs = torch.empty((t * k, d), dtype=x.dtype, device=x.device)
    pairs[route.order] = gathered * route.gates[:, None].to(x.dtype)
    out = pairs.reshape(t, k, d).sum(1)

    frac_tokens = route.counts.float() / (t * k)
    mean_prob = route.probs.mean(0)
    aux = e * torch.sum(frac_tokens * mean_prob)
    return out.reshape(b, s, d), aux
