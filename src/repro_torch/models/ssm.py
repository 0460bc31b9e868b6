"""Mamba-1 selective SSM block (falcon-mamba / hymba SSM heads), the
training forward and the decode state of ``repro.models.ssm``.

The reference keeps the (B, S, d_inner, N) discretised tensors out of memory
by an outer scan over sequence chunks, each rematerialised under
``jax.checkpoint``, with an exact inner scan that advances

    h_t = exp(Δ_t·A)·h_{t-1} + Δ_t·B_t·x_t,   y_t = <C_t, h_t> + D·x_t.

Here both scans are one registered operator,
``torch.ops.repro_torch.ssm_scan`` (:mod:`repro_torch.models.ssm_scan`),
whose body is a Python loop over chunks and, inside each, over steps (two
launches a step: ``addcmul`` and a batched product); it keeps each chunk's
starting state, as the reference's checkpointed outer scan does, and its
backward scans the chunks in reverse from them.  The reference has no
Pallas kernel here, so neither has the port; the loop is plain PyTorch.
Weights are (out, in) like every dense weight of the port; ``conv_w``
stays (k, d_inner) as in the reference.

Decode carries a state ``{'conv': (B, k - 1, d_inner), 'h': (B, d_inner,
N) f32}``: the causal conv's last k - 1 inputs and the recurrence.  A
prefill runs the chunked scan from it (``ssm_apply(state=...,
return_state=True)``), a decode token advances it by :func:`ssm_step`.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, dtype_of
from repro_torch.models.ssm_scan import scan

Params = Mapping[str, torch.Tensor]


def ssm_init(generator: torch.Generator, cfg: ModelConfig,
             device: str | torch.device = "cpu") -> dict:
    dt = dtype_of(cfg)
    d, di, n, dr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
    a = torch.arange(1, n + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(di, 1)
    conv_w = torch.randn((cfg.ssm_conv, di), generator=generator,
                         device=generator.device) * cfg.ssm_conv ** -0.5
    return {
        "in_proj": dense_init(generator, d, 2 * di, dt, device=device),
        "conv_w": conv_w.to(device=device, dtype=dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "x_proj": dense_init(generator, di, dr + 2 * n, dt, device=device),
        "dt_proj": dense_init(generator, dr, di, dt, device=device),
        "dt_bias": torch.zeros((di,), dtype=torch.float32, device=device),
        "A_log": torch.log(a),                                 # (di, N) f32
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, di, d, dt, scale=di ** -0.5,
                               device=device),
    }


def _projections(params: Params, cfg: ModelConfig, u: torch.Tensor):
    """u: (B, S, di) post-conv -> delta (B, S, di) f32, B and C (B, S, N)."""
    n, dr = cfg.ssm_state, cfg.dt_rank_
    xdbc = F.linear(u, params["x_proj"]).float()               # (B, S, dr+2N)
    dt_in, bmat, cmat = torch.split(xdbc, [dr, n, n], dim=-1)
    delta = F.softplus(F.linear(dt_in, params["dt_proj"].float())
                       + params["dt_bias"])                    # (B, S, di)
    return delta, bmat, cmat


def _causal_conv(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 conv_cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x: (B, S, di); ``conv_cache`` the k - 1
    inputs before x (zeros when None).  Returns the output in x's dtype and
    the last k - 1 inputs of the padded sequence (the next conv cache)."""
    kk, s = cfg.ssm_conv, x.shape[1]
    if conv_cache is None:
        pad = torch.zeros((x.shape[0], kk - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                            # (B, S+k-1, di)
    w = params["conv_w"].float()                               # (k, di)
    out = xp[:, 0:s].float() * w[0]
    for i in range(1, kk):
        out = out + xp[:, i:i + s].float() * w[i]
    out = out + params["conv_b"].float()
    new_cache = xp[:, xp.shape[1] - (kk - 1):] if kk > 1 else pad
    return out.to(x.dtype), new_cache


def ssm_apply(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
              chunk: int = 64, state: Optional[dict] = None,
              return_state: bool = False):
    """Training / prefill forward.  x: (B, S, d) -> (B, S, d); the
    recurrence in f32, the output in x's dtype.  ``state``: a carried
    decode state ``{'conv', 'h'}`` to continue from (zeros when None);
    ``return_state=True`` also returns the final ``{'conv', 'h'}``, exact
    (the padded steps leave h unchanged), the conv in ``conv_w``'s dtype."""
    b = x.shape[0]
    di, n = cfg.d_inner, cfg.ssm_state
    u, z = torch.chunk(F.linear(x, params["in_proj"]), 2, dim=-1)
    u, new_conv = _causal_conv(params, cfg, u,
                               None if state is None else state["conv"])
    u = F.silu(u.float()).to(x.dtype)
    delta, bmat, cmat = _projections(params, cfg, u)
    a = -torch.exp(params["A_log"])                            # (di, N)
    uf = u.float()

    h = (torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
         if state is None else state["h"])
    y, h = scan(delta, uf, bmat, cmat, a, h, chunk)
    y = y + params["D"] * uf
    y = y * F.silu(z.float())
    out = F.linear(y.to(x.dtype), params["out_proj"])
    if not return_state:
        return out
    return out, {"conv": new_conv.to(params["conv_w"].dtype), "h": h}


def ssm_init_state(cfg: ModelConfig, batch: int,
                   dtype: torch.dtype = torch.float32,
                   device: str | torch.device = "cpu") -> dict:
    """The zero decode state: conv (B, k - 1, d_inner) in ``dtype``, h
    (B, d_inner, N) in f32."""
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


def ssm_step(params: Params, cfg: ModelConfig, x: torch.Tensor,
             state: dict) -> tuple[torch.Tensor, dict]:
    """One decode token.  x: (B, 1, d) -> (out (B, 1, d), new state); the
    conv state keeps its dtype."""
    u, z = torch.chunk(F.linear(x, params["in_proj"]), 2, dim=-1)
    u, new_conv = _causal_conv(params, cfg, u, state["conv"])
    u = F.silu(u.float()).to(x.dtype)
    delta, bmat, cmat = _projections(params, cfg, u)           # (B, 1, ...)
    a = -torch.exp(params["A_log"])
    da = torch.exp(delta[:, 0, :, None] * a)                   # (B, di, N)
    dbu = (delta[:, 0] * u[:, 0].float())[..., None] * bmat[:, 0, None, :]
    h = state["h"] * da + dbu                                  # (B, di, N)
    y = torch.bmm(h, cmat[:, 0, :, None])[..., 0][:, None]     # (B, 1, di)
    y = y + params["D"] * u.float()
    y = y * F.silu(z.float())
    out = F.linear(y.to(x.dtype), params["out_proj"])
    return out, {"conv": new_conv.to(state["conv"].dtype), "h": h}
