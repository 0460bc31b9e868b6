"""A hybrid decoder LM of hymba's kind (arXiv:2411.13676) as the port
states it, in plain PyTorch f32, with its loss and Adam.

Each of the L blocks is pre-norm: h = RMSNorm(x); the block mixes h with
causal sliding-window GQA attention (RoPE on q and k, half-split layout)
and a Mamba-1 selective-SSM head side by side, x += (attn + ssm) / 2; then
x += SwiGLU(RMSNorm(x)).  The SSM head: u, z = in_proj(h); u = SiLU(causal
depthwise conv(u)); Δ = softplus(dt_proj(x_proj(u)[:R]) + dt_bias); B, C
the rest of x_proj(u); h_t = exp(Δ_t·A)·h_{t-1} + Δ_t·u_t·B_t, y_t =
<C_t, h_t> + D·u_t, y *= SiLU(z); out_proj(y), A = -exp(A_log).  The head
is the tied embedding; the loss is the mean next-token cross-entropy.
Departures from the published Hymba (meta tokens, cross-layer KV sharing,
three full-attention layers) are the port's and listed in the
configuration's file.

Parameter names and layouts (dense weights (out, in)) are the port's, so
:func:`initial_leaves` hands the same values to both sides.  ``linear``
takes a quantiser: the f32 reference passes the identity, the lower
precision control an fp8 round trip (:func:`fp8`).
"""
from __future__ import annotations

import math
from typing import Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from portbench.harness import traffic

Quant = Callable[[torch.Tensor], torch.Tensor]


def leaves(cfg: dict) -> list[tuple[str, tuple[int, ...], str, bool]]:
    """(name, shape, init, kept in f32) of every parameter, in the order
    the weights are drawn.  init: "normal:<scale>" (scale "fan" = the
    input width ** -0.5), "ones", "zeros" or "a_log"."""
    d, dh, hq, hkv = cfg["d_model"], cfg["d_head"], cfg["n_heads"], \
        cfg["n_kv_heads"]
    di, n, dr, ff, k = cfg["ssm_expand"] * d, cfg["ssm_state"], \
        cfg["dt_rank"], cfg["d_ff"], cfg["ssm_conv"]
    out = [("embed", (cfg["vocab"], d), "normal:0.02", False),
           ("ln_f.scale", (d,), "ones", False)]
    for i in range(cfg["n_layers"]):
        pre = f"layers.{i}."
        out += [(pre + "ln1.scale", (d,), "ones", False),
                (pre + "attn.wq", (hq * dh, d), "normal:fan", False),
                (pre + "attn.wk", (hkv * dh, d), "normal:fan", False),
                (pre + "attn.wv", (hkv * dh, d), "normal:fan", False),
                (pre + "attn.wo", (d, hq * dh), "normal:fan", False),
                (pre + "ssm.in_proj", (2 * di, d), "normal:fan", False),
                (pre + "ssm.conv_w", (k, di), f"normal:{k ** -0.5}", False),
                (pre + "ssm.conv_b", (di,), "zeros", False),
                (pre + "ssm.x_proj", (dr + 2 * n, di), "normal:fan", False),
                (pre + "ssm.dt_proj", (di, dr), "normal:fan", False),
                (pre + "ssm.dt_bias", (di,), "zeros", True),
                (pre + "ssm.A_log", (di, n), "a_log", True),
                (pre + "ssm.D", (di,), "ones", True),
                (pre + "ssm.out_proj", (d, di), "normal:fan", False),
                (pre + "ln2.scale", (d,), "ones", False),
                (pre + "mlp.wi_gate", (ff, d), "normal:fan", False),
                (pre + "mlp.wi_up", (ff, d), "normal:fan", False),
                (pre + "mlp.wo", (d, ff), "normal:fan", False)]
    return out


def initial_leaves(cfg: dict, seed: int, device, dtype: torch.dtype
                   ) -> Iterator[tuple[str, torch.Tensor]]:
    """The initial parameters from the seed, leaf by leaf: the normal
    draws come from a few large calls (:class:`traffic.NormalStream`),
    each leaf in ``dtype`` (the served type) or f32 where it is kept so."""
    spec = leaves(cfg)
    z = traffic.NormalStream(
        traffic.generator(seed, "weights", device),
        sum(math.prod(s) for _, s, init, _ in spec
            if init.startswith("normal")))
    for name, shape, init, f32 in spec:
        dt = torch.float32 if f32 else dtype
        if init == "ones":
            t = torch.ones(shape, dtype=dt, device=device)
        elif init == "zeros":
            t = torch.zeros(shape, dtype=dt, device=device)
        elif init == "a_log":
            a = torch.arange(1, shape[1] + 1, dtype=torch.float32,
                             device=device)
            t = torch.log(a)[None, :].repeat(shape[0], 1).to(dt)
        else:
            scale = init.split(":")[1]
            s = shape[1] ** -0.5 if scale == "fan" else float(scale)
            t = (z.take(math.prod(shape)).view(shape) * s).to(dt)
        yield name, t


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """A round trip through float8 e4m3 with one scale a tensor; the
    gradient passes straight through the rounding."""
    s = t.detach().abs().amax().clamp(min=1e-12) / 448.0
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (q - t.detach())


def linear(x, w, q: Quant):
    return q(x) @ q(w).T


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x (B, H, S, Dh), positions 0..S-1, half-split rotation."""
    s, dh = x.shape[-2], x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(p, pre, cfg, h, q: Quant):
    b, s, _ = h.shape
    hq, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]

    def heads(t, n):
        return t.view(b, s, n, dh).transpose(1, 2)

    qh = rope(heads(linear(h, p[pre + "attn.wq"], q), hq), cfg["rope_theta"])
    kh = rope(heads(linear(h, p[pre + "attn.wk"], q), hkv), cfg["rope_theta"])
    vh = heads(linear(h, p[pre + "attn.wv"], q), hkv)
    kh = kh.repeat_interleave(hq // hkv, 1)
    vh = vh.repeat_interleave(hq // hkv, 1)
    pos = torch.arange(s, device=h.device)
    keep = pos[None, :] <= pos[:, None]
    if cfg.get("window"):
        keep = keep & (pos[None, :] > pos[:, None] - cfg["window"])
    logits = (qh @ kh.transpose(-1, -2)) * dh ** -0.5
    probs = torch.softmax(logits.masked_fill(~keep, float("-inf")), -1)
    out = (probs @ vh).transpose(1, 2).reshape(b, s, hq * dh)
    return linear(out, p[pre + "attn.wo"], q)


def ssm(p, pre, cfg, h, q: Quant):
    k, n, dr = cfg["ssm_conv"], cfg["ssm_state"], cfg["dt_rank"]
    u, z = linear(h, p[pre + "ssm.in_proj"], q).chunk(2, -1)
    s = u.shape[1]
    up = F.pad(u, (0, 0, k - 1, 0))
    w = p[pre + "ssm.conv_w"]
    u = sum(up[:, i:i + s] * w[i] for i in range(k)) + p[pre + "ssm.conv_b"]
    u = F.silu(u)
    dt_in, bm, cm = linear(u, p[pre + "ssm.x_proj"], q).split(
        [dr, n, n], -1)
    delta = F.softplus(linear(dt_in, p[pre + "ssm.dt_proj"], q)
                       + p[pre + "ssm.dt_bias"])
    a = -torch.exp(p[pre + "ssm.A_log"])
    da = torch.exp(delta[..., None] * a)                     # (B, S, di, N)
    dbu = (delta * u)[..., None] * bm[:, :, None, :]
    # the steps' slices by unbind, whose backward is one stack (indexing
    # da[:, t] would add a full (B, S, di, N) gradient for every step)
    hs, state = [], torch.zeros_like(da[:, 0])
    for da_t, dbu_t in zip(da.unbind(1), dbu.unbind(1)):
        state = da_t * state + dbu_t
        hs.append(state)
    y = torch.einsum("bsdn,bsn->bsd", torch.stack(hs, 1), cm)
    y = (y + p[pre + "ssm.D"] * u) * F.silu(z)
    return linear(y, p[pre + "ssm.out_proj"], q)


def block(x, p, i: int, cfg, q: Quant):
    pre = f"layers.{i}."
    eps = cfg["norm_eps"]
    h = rmsnorm(x, p[pre + "ln1.scale"], eps)
    x = x + 0.5 * (attention(p, pre, cfg, h, q) + ssm(p, pre, cfg, h, q))
    h = rmsnorm(x, p[pre + "ln2.scale"], eps)
    g = F.silu(linear(h, p[pre + "mlp.wi_gate"], q)) * \
        linear(h, p[pre + "mlp.wi_up"], q)
    return x + linear(g, p[pre + "mlp.wo"], q)


def loss(p: dict, cfg: dict, tokens: torch.Tensor, q: Quant = identity):
    """Mean next-token cross-entropy of (B, S) ``tokens``."""
    x = p["embed"][tokens]
    for i in range(cfg["n_layers"]):
        x = block(x, p, i, cfg, q)
    x = rmsnorm(x, p["ln_f.scale"], cfg["norm_eps"])
    logits = linear(x, p["embed"], q)[:, :-1]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8), bias corrections in f32."""

    def __init__(self, params: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        f = np.float32
        bc1 = float(f(1) - f(self.b1) ** f(self.t))
        bc2 = float(f(1) - f(self.b2) ** f(self.t))
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.v[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            p.add_(-self.lr * (self.m[k] / bc1)
                   / (torch.sqrt(self.v[k] / bc2) + self.eps))


def train(cfg: dict, params: dict, batches: list[torch.Tensor], lr: float,
          micro: int, q: Quant = identity) -> dict:
    """Adam steps from ``params`` (left as they are) on ``batches`` (each
    (B, S) tokens), ``micro`` rows at a time.  Returns each step's loss, the first step's gradient norm of
    every leaf and every leaf's change after the last step."""
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    opt = Adam(p, lr)
    losses, grad_norms = [], None
    for tokens in batches:
        rows = tokens.shape[0]
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        total = 0.0
        for r in range(0, rows, micro):
            part = tokens[r:r + micro]
            frac = part.shape[0] / rows
            l = loss(p, cfg, part, q)
            g = torch.autograd.grad(l * frac, list(p.values()))
            for (k, acc), gk in zip(grads.items(), g):
                acc.add_(gk)
            total += float(l.detach()) * frac
        losses.append(total)
        if grad_norms is None:
            grad_norms = {k: float(torch.linalg.vector_norm(g))
                          for k, g in grads.items()}
        del g
        opt.step(p, grads)
        del grads
    change = {k: float(torch.linalg.vector_norm(p[k].detach() - params[k]))
              for k in p}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}
