"""Functional NN layers: norms, RoPE, GQA attention (full / windowed / cross
/ cached decode), MLPs.

Every layer is an ``init(generator, ...) -> params`` / ``apply(params, x,
...)`` pair over dicts of tensors, as in ``repro.models.layers``; the
modules of :mod:`repro_torch.models.transformer` hold the dicts.  Dense
weights are (out, in), PyTorch's layout, applied with ``F.linear``; the
reference keeps them (in, out), and :mod:`repro_torch.carry` transposes.

The cache-free full-sequence call goes through the flash kernel when
:data:`USE_FLASH_KERNEL` is set; cached and cross attention stay plain
torch on every device, as the reference computes them in XLA outside its
Pallas kernel.  A cache is updated in place.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig

Params = Mapping[str, torch.Tensor]

# Route full-sequence attention through the hand-written flash kernel
# (repro_torch.kernels.flash_attention).  Default off, as in the reference;
# the train CLI's --flash turns it on.
USE_FLASH_KERNEL: bool = False


def set_flash_kernel(on: bool) -> None:
    global USE_FLASH_KERNEL
    USE_FLASH_KERNEL = on


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, scale: float | None = None,
               device: str | torch.device = "cpu") -> torch.Tensor:
    """(d_out, d_in) weight, N(0, 1) * scale (default d_in ** -0.5) drawn
    in f32 on the generator's device, cast to ``dtype``."""
    if scale is None:
        scale = d_in ** -0.5
    w = torch.randn((d_out, d_in), generator=generator,
                    device=generator.device) * scale
    return w.to(device=device, dtype=dtype)


# --- norms -------------------------------------------------------------------

def rmsnorm_init(d: int, dtype: torch.dtype,
                 device: str | torch.device = "cpu") -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(x.dtype)


# --- rotary embeddings ---------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         fraction: float = 1.0) -> torch.Tensor:
    """Apply rotary embeddings to the leading ``fraction`` of the head dim.

    x: (..., S, Dh); positions: broadcastable to (..., S).  Half-split
    layout ``[x1 cos - x2 sin, x1 sin + x2 cos]``, computed in f32.
    ``fraction=0.5`` reproduces chatglm3's partial ("2d") rotary.
    """
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs              # (..., S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    xr = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([xr.to(x.dtype), x_pass], dim=-1)


# --- attention -----------------------------------------------------------------

def attention_init(generator: torch.Generator, cfg: ModelConfig,
                   device: str | torch.device = "cpu") -> dict:
    """QKVO projections (and the qkv bias where the config has one)."""
    dt = dtype_of(cfg)
    d, dh, hq, hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(generator, d, hq * dh, dt, device=device),
        "wk": dense_init(generator, d, hkv * dh, dt, device=device),
        "wv": dense_init(generator, d, hkv * dh, dt, device=device),
        "wo": dense_init(generator, hq * dh, d, dt, scale=(hq * dh) ** -0.5,
                         device=device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh),
                            ("bv", hkv * dh)):
            p[name] = torch.zeros((width,), dtype=dt, device=device)
    return p


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1).transpose(1, 2)       # (B, H, S, Dh)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _sdpa(q, k, v, *, causal: bool, window: Optional[int], scale: float,
          kv_len: Optional[torch.Tensor] = None,
          valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain scaled-dot-product attention with GQA broadcast, softmax in
    f32.  q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh); queries sit at the
    end of the K/V timeline.  ``kv_len``: the number of valid cache entries
    (a 0-d tensor; decode with a partly filled cache), the queries ending
    there.  ``valid_mask``: an explicit (Skv,) slot-validity mask (a ring
    buffer, whose slot order is not position order)."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    qf = q.float().reshape(b, hkv, group, sq, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if valid_mask is not None:
        mask = valid_mask[None, :].expand(sq, skv)
    else:
        mask = ref.attention_mask(sq, skv, causal, window, q.device, kv_len)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, sq, dh).to(q.dtype)


def _write(buf: torch.Tensor, new: torch.Tensor,
           start: torch.Tensor) -> None:
    """Write ``new`` (B, H, S, Dh) into ``buf`` (B, H, S_max, Dh) at slots
    ``start`` .. ``start`` + S - 1 along axis 2, in place (``start`` a 0-d
    tensor: no host read).  The slots must lie inside ``buf``."""
    slots = start + torch.arange(new.shape[2], device=buf.device)
    buf.index_copy_(2, slots, new.to(buf.dtype))


def attention_apply(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                    positions: torch.Tensor,
                    cache: Optional[dict] = None,
                    cache_index: Optional[torch.Tensor] = None,
                    memory: Optional[torch.Tensor] = None,
                    causal: bool = True, use_rope: bool = True
                    ) -> tuple[torch.Tensor, Optional[dict]]:
    """GQA attention over x: (B, S, d).  Returns (out, cache).

    Modes:
      * training / prefill without a cache: ``cache=None``, full
        self-attention, through the flash kernel when
        :data:`USE_FLASH_KERNEL` is set, else :func:`_sdpa`;
      * decode: ``cache={'k', 'v'}`` (B, Hkv, S_max, Dh) and
        ``cache_index`` (a 0-d integer tensor) the number of tokens already
        cached; x holds the new token(s), whose K/V are written into the
        cache in place.  A cache of ``cfg.window`` slots is a ring buffer:
        slot = index mod window, the keys keep RoPE at their absolute
        positions, and an explicit validity mask stands for the window
        (a write must not wrap: one token a decode step, and a prompt
        that fits the window);
      * cross-attention: ``memory`` (B, S_enc, d) supplies K/V (no cache,
        no rope, no mask).
    """
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    scale = dh ** -0.5
    kv_in = memory if memory is not None else x
    q = _split_heads(F.linear(x, params["wq"], params.get("bq")), hq)
    k = _split_heads(F.linear(kv_in, params["wk"], params.get("bk")), hkv)
    v = _split_heads(F.linear(kv_in, params["wv"], params.get("bv")), hkv)
    if memory is not None:
        out = _sdpa(q, k, v, causal=False, window=None, scale=scale)
        return F.linear(_merge_heads(out), params["wo"]), None
    if use_rope:
        q = rope(q, positions[:, None, :], cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, positions[:, None, :], cfg.rope_theta, cfg.rope_fraction)
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        size, s = ck.shape[2], x.shape[1]
        if cfg.window is not None and size == cfg.window:     # ring buffer
            slot = torch.remainder(cache_index, size)
            _write(ck, k, slot)
            _write(cv, v, slot)
            valid = (torch.arange(size, device=x.device)
                     < torch.clamp(cache_index + s, max=size))
            out = _sdpa(q, ck, cv, causal=False, window=None, scale=scale,
                        valid_mask=valid)
        else:
            _write(ck, k, cache_index)
            _write(cv, v, cache_index)
            out = _sdpa(q, ck, cv, causal=True, window=cfg.window,
                        scale=scale, kv_len=cache_index + s)
        return F.linear(_merge_heads(out), params["wo"]), {"k": ck, "v": cv}
    if USE_FLASH_KERNEL:
        out = ops.flash_attention(q, k, v, causal=causal, window=cfg.window,
                                  scale=scale)
    else:
        out = _sdpa(q, k, v, causal=causal, window=cfg.window, scale=scale)
    return F.linear(_merge_heads(out), params["wo"]), None


# --- MLPs ----------------------------------------------------------------------

def mlp_init(generator: torch.Generator, cfg: ModelConfig,
             device: str | torch.device = "cpu") -> dict:
    dt = dtype_of(cfg)
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"wi_gate": dense_init(generator, d, ff, dt, device=device),
                "wi_up": dense_init(generator, d, ff, dt, device=device),
                "wo": dense_init(generator, ff, d, dt, scale=ff ** -0.5,
                                 device=device)}
    return {"wi": dense_init(generator, d, ff, dt, device=device),
            "wo": dense_init(generator, ff, d, dt, scale=ff ** -0.5,
                             device=device)}


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (``wi_gate``/``wi_up``) or GELU (``wi``; the tanh form, as
    ``jax.nn.gelu`` defaults to), the activation in f32."""
    if "wi_gate" in params:
        h = F.silu(F.linear(x, params["wi_gate"]).float()).to(x.dtype)
        h = h * F.linear(x, params["wi_up"])
        return F.linear(h, params["wo"])
    h = F.gelu(F.linear(x, params["wi"]).float(), approximate="tanh")
    return F.linear(h.to(x.dtype), params["wo"])
