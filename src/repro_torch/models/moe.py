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
``torch.bmm`` takes; the router is a dense (E, d) weight in f32.

Expert parallelism (:func:`moe_apply_ep`, the reference's shard_map
version over ``torch.distributed``): the tokens split over the mesh's
token axes, the experts contiguously over ``expert_axis`` and their hidden
dim over ``model_axis``.  Each rank routes its tokens, buckets the (token,
choice) pairs by the rank that owns their expert, ships them with an
all-to-all, dispatches what it receives to its E / R experts by the same
sort, runs the SwiGLU, ships the rows back and combines; the ``model``-axis
partial sums are added after the combine, on the token rows.  The
all-to-alls are ``torch.distributed.nn.functional.all_to_all_single``,
which has a backward.  :func:`enable_expert_parallel` makes
:func:`moe_apply` route through it (the model's MoE layers then hold their
rank's experts, or the whole stacks, which it slices).
"""
from __future__ import annotations

import math
import warnings
from typing import Mapping, NamedTuple

import torch
import torch.distributed as dist
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


def _bincount(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids in [0, n): the same
    int64 counts, with an output shape that does not depend on the data
    (so the step also traces on fake tensors, :mod:`repro_torch.launch.dryrun`)."""
    ids = ids.long()
    return torch.zeros((n,), dtype=torch.long, device=ids.device).scatter_add(
        0, ids, torch.ones_like(ids))


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
    counts = _bincount(flat_e, e)                               # (E,)
    starts = torch.cumsum(counts, 0) - counts                  # exclusive
    pos = torch.arange(t * k, device=xt.device) - starts[sorted_e]
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos,
                       torch.full_like(pos, e * cap))
    return Dispatch(order, slot, keep, gate_vals.reshape(-1)[order], counts,
                    probs)


#: expert parallelism's mesh and axes while enabled (the reference's
#: module switch, which its callers set around a run)
_EP: dict = {"mesh": None, "token_axes": ("data",), "expert_axis": "data",
             "model_axis": "model"}


def enable_expert_parallel(mesh, *, token_axes=("data",),
                           expert_axis: str = "data",
                           model_axis: str = "model") -> None:
    """Route :func:`moe_apply` through :func:`moe_apply_ep` on ``mesh``."""
    _EP.update(mesh=mesh, token_axes=tuple(token_axes),
               expert_axis=expert_axis, model_axis=model_axis)


def disable_expert_parallel() -> None:
    _EP["mesh"] = None


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def moe_apply(params: Params, cfg: ModelConfig,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux load-balance loss (), f32):
    through :func:`moe_apply_ep` while expert parallelism is enabled and
    the expert axis divides the experts, else the one-device dispatch."""
    mesh = _EP["mesh"]
    if mesh is not None and \
            cfg.n_experts % _sizes(mesh)[_EP["expert_axis"]] == 0:
        return moe_apply_ep(params, cfg, x, mesh=mesh,
                            token_axes=_EP["token_axes"],
                            expert_axis=_EP["expert_axis"],
                            model_axis=_EP["model_axis"])
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


def _sort_dispatch(x_flat: torch.Tensor, ids: torch.Tensor, n_buckets: int,
                   cap: int):
    """Sort the rows of ``x_flat`` (M, d) stably by bucket id into an
    (n_buckets, cap, d) buffer; an id < 0 is dropped, as is every row past
    its bucket's capacity.  Returns (buf, slot, keep): ``slot`` each input
    row's flat buffer row (meaningless where ``keep`` is False)."""
    m, d = x_flat.shape
    key = torch.where(ids < 0, torch.full_like(ids, n_buckets), ids)
    order = torch.argsort(key, stable=True)
    sorted_ids = key[order]
    counts = _bincount(key, n_buckets + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(m, device=x_flat.device) - starts[sorted_ids]
    keep_sorted = (pos < cap) & (sorted_ids < n_buckets)
    slot_sorted = torch.where(keep_sorted, sorted_ids * cap + pos,
                              torch.full_like(pos, n_buckets * cap))
    rows = torch.where(keep_sorted[:, None], x_flat[order], 0.0)
    buf = torch.zeros((n_buckets * cap + 1, d), dtype=x_flat.dtype,
                      device=x_flat.device).index_put((slot_sorted,), rows)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    keep = torch.empty_like(keep_sorted)
    keep[order] = keep_sorted
    return buf[:-1].reshape(n_buckets, cap, d), slot, keep


def _differentiable(name: str, *args, group):
    """``torch.distributed.nn.functional.<name>``: a collective with a
    backward.  Its deprecation warning is silenced: the functional
    collectives that succeed it have no backward on every backend."""
    import torch.distributed.nn.functional as dist_fn

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return getattr(dist_fn, name)(*args, group=group)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-to-all over the leading (ranks) dim."""
    return _differentiable("all_to_all_single", torch.empty_like(t),
                           t.contiguous(), group=group)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group``."""
    return _differentiable("all_reduce", t, group=group)


def _local_stacks(params: Params, d_ff: int, e_local: int, rank_e: int,
                  mdl: int, rank_m: int) -> tuple[torch.Tensor, ...]:
    """This rank's expert stacks: its E / R experts, its ff / M hidden
    slice; taken from the whole stacks where those are given."""
    wig, wiu, wo = params["wi_gate"], params["wi_up"], params["wo"]
    if wig.shape[0] != e_local:
        lo = rank_e * e_local
        wig, wiu, wo = (t[lo:lo + e_local] for t in (wig, wiu, wo))
    if mdl > 1 and wo.shape[1] == d_ff:
        f = d_ff // mdl
        lo = rank_m * f
        wig, wiu = wig[:, :, lo:lo + f], wiu[:, :, lo:lo + f]
        wo = wo[:, lo:lo + f]
    return wig, wiu, wo


def moe_apply_ep(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                 mesh, token_axes=("data",), expert_axis: str = "data",
                 model_axis: str = "model",
                 stats: dict | None = None,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over a DeviceMesh, as the reference's.

    ``x`` is this rank's (B_l, S, d) token block; ``params`` the router
    (E, d) and this rank's expert stacks ((E / R, d, ff / M) and (E / R,
    ff / M, d), R ranks on ``expert_axis``, M on ``model_axis``; whole
    stacks are sliced to them).  Per EP group: route -> bucket the (token,
    choice) pairs by owner rank (capacity ``max(4, ceil(int(cf * T_l * k)
    / R))`` a rank) -> all-to-all -> sort to the rank's experts (capacity
    ``max(4, ceil(cf * R * C_s / (E / R)))``) -> SwiGLU -> all-to-all back
    -> the gate-weighted sum over each token's choices -> the sum over
    ``model_axis``.  The aux loss uses the counts and router means over
    every token axis.  ``stats``: filled with ``dropped``, the pairs either
    capacity dropped over the whole group.  Returns (out (B_l, S, d), aux
    ())."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    sizes = _sizes(mesh)
    r = sizes[expert_axis]
    e_local = e // r
    mdl = sizes.get(model_axis, 1)
    rank_e = mesh.get_local_rank(expert_axis)
    rank_m = mesh.get_local_rank(model_axis) if model_axis in sizes else 0
    wig, wiu, wo = _local_stacks(params, cfg.d_ff, e_local, rank_e, mdl,
                                 rank_m)
    group = mesh.get_group(expert_axis)

    t_l = b * s
    xt = x.reshape(t_l, d)
    logits = F.linear(xt.float(), params["router"])            # (T_l, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)       # (T_l, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    flat_e = expert_idx.reshape(-1)                            # (T_l*K,)
    src_token = torch.arange(t_l * k, device=x.device) // k
    dest_rank = flat_e // e_local
    cap_s = max(4, -(-int(cfg.capacity_factor * t_l * k) // r))
    send, slot_send, keep_send = _sort_dispatch(xt[src_token], dest_rank, r,
                                                cap_s)         # (R, C_s, d)
    # each sent row's expert on its owner, -1 on an empty slot (a zero row
    # could be a real token)
    meta = torch.full((r * cap_s + 1,), -1, dtype=torch.long, device=x.device)
    meta[torch.where(keep_send, slot_send, r * cap_s)] = torch.where(
        keep_send, flat_e % e_local, -1)
    meta = meta[:-1].reshape(r, cap_s).contiguous()

    recv = _all_to_all(send, group)
    meta_r = torch.empty_like(meta)
    dist.all_to_all_single(meta_r, meta, group=group)

    m = r * cap_s
    cap_e = max(4, int(-(-cfg.capacity_factor * m // e_local)))
    buf, slot_e, keep_e = _sort_dispatch(recv.reshape(m, d),
                                         meta_r.reshape(m), e_local, cap_e)
    h_g = torch.bmm(buf, wig)
    h_u = torch.bmm(buf, wiu)
    h = F.silu(h_g.float()).to(buf.dtype) * h_u
    out_e = torch.bmm(h, wo)                       # a partial sum over ff / M
    out_flat = out_e.reshape(e_local * cap_e, d)
    out_rows = torch.where(
        keep_e[:, None],
        out_flat[torch.clamp(slot_e, max=e_local * cap_e - 1)], 0.0)
    back = _all_to_all(out_rows.reshape(r, cap_s, d), group).reshape(m, d)
    contrib = torch.where(keep_send[:, None],
                          back[torch.clamp(slot_send, max=m - 1)], 0.0)
    contrib = contrib * gate_vals.reshape(-1)[:, None].to(contrib.dtype)
    # the sum over the choices in a fixed order, as moe_apply's
    out = contrib.reshape(t_l, k, d).sum(1)
    if mdl > 1:
        out = _all_reduce(out, mesh.get_group(model_axis))

    # the Switch aux loss over every token of the group
    counts_g = _bincount(flat_e, e).float()
    probs_sum = probs.sum(0)
    for axis in token_axes:
        g = mesh.get_group(axis)
        dist.all_reduce(counts_g, group=g)
        probs_sum = _all_reduce(probs_sum, g)
    t_total = t_l * math.prod(sizes[a] for a in token_axes)
    aux = e * torch.sum((counts_g / (t_total * k)) * (probs_sum / t_total))
    if stats is not None:
        valid = meta_r.reshape(m) >= 0
        dropped = ((~keep_send).sum() + (valid & ~keep_e).sum()).float()
        dist.all_reduce(dropped, group=group)
        stats["dropped"] = int(dropped)
    return out.reshape(b, s, d), aux
