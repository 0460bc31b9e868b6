"""A tiny row-token transformer classifier for the FL loop (``--model
transformer_tiny``), the port of ``repro.models.tiny_transformer``.

Treats a (B, 28, 28, 1) image as 28 tokens of dim 28 (one per pixel row),
runs 2 pre-LN attention blocks at d_model=32, mean-pools, and classifies.
It is the federation contract's stress model rather than a serious
classifier:

  * float params are **bfloat16** — client updates go through the
    coalition geometry in their native dtype, so W is a bf16 (N, 27,626)
    matrix and the fused round runs its bf16 routes;
  * ``pos_ids`` is an **int32 buffer** inside the params, used for the
    positional-embedding lookup — federation carries it through untouched
    and it stays out of W (:mod:`repro_torch.core.pytree`).

Math runs in f32 (params cast up per use, logits/loss in f32); gradients
land back in each leaf's native dtype.  Parameters are a flat dict named
``blocks.<i>.<layer>.<leaf>``, ``embed.w`` and so on, each in the
reference's layout ((in, out) dense weights), so :data:`REF_LAYOUT` needs
no permutation.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class TinyConfig(NamedTuple):
    n_tokens: int = 28        # image rows as tokens
    d_in: int = 28            # pixels per row
    d_model: int = 32
    n_heads: int = 4
    n_blocks: int = 2
    mlp_mult: int = 4
    n_classes: int = 10


_DENSE = ("attn_out", "mlp_dn", "mlp_up", "qkv")


def ref_layout(cfg: TinyConfig = TinyConfig()) -> tuple:
    """``(parameter, reference leaf, None)`` triples in the reference's
    flatten order (dict keys sorted, blocks by index); ``pos_ids`` is the
    buffer the geometry skips."""
    def leaf(path: str) -> tuple:
        return (path.replace("/", "."), path, None)

    entries = []
    for i in range(cfg.n_blocks):
        for layer in ("attn_out", "ln1", "ln2", "mlp_dn", "mlp_up", "qkv"):
            names = ("b", "w") if layer in _DENSE else ("bias", "scale")
            entries += [leaf(f"blocks/{i}/{layer}/{n}") for n in names]
    entries += [leaf("embed/b"), leaf("embed/w"), leaf("head/b"),
                leaf("head/w"), leaf("ln_f/bias"), leaf("ln_f/scale"),
                leaf("pos_ids"), leaf("pos_table")]
    return tuple(entries)


REF_LAYOUT = ref_layout()


def init(generator: torch.Generator, device: str | torch.device = "cpu",
         cfg: TinyConfig = TinyConfig(),
         dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """Scaled-normal dense weights, zero biases, unit LN scales and a 0.02
    normal position table, drawn in f32 from ``generator`` on the CPU and
    cast to ``dtype``: the reference's distribution, not its draws (parity
    tests carry its weights across with :func:`repro_torch.carry`)."""
    params: dict[str, torch.Tensor] = {}

    def dense(name, n_in, n_out):
        w = torch.randn((n_in, n_out), generator=generator) * math.sqrt(
            1.0 / n_in)
        params[f"{name}.w"] = w.to(dtype)
        params[f"{name}.b"] = torch.zeros((n_out,), dtype=dtype)

    def ln(name):
        params[f"{name}.scale"] = torch.ones((cfg.d_model,), dtype=dtype)
        params[f"{name}.bias"] = torch.zeros((cfg.d_model,), dtype=dtype)

    dense("embed", cfg.d_in, cfg.d_model)
    params["pos_table"] = (torch.randn((cfg.n_tokens, cfg.d_model),
                                       generator=generator) * 0.02).to(dtype)
    dense("head", cfg.d_model, cfg.n_classes)
    for i in range(cfg.n_blocks):
        ln(f"blocks.{i}.ln1")
        dense(f"blocks.{i}.qkv", cfg.d_model, 3 * cfg.d_model)
        dense(f"blocks.{i}.attn_out", cfg.d_model, cfg.d_model)
        ln(f"blocks.{i}.ln2")
        dense(f"blocks.{i}.mlp_up", cfg.d_model, cfg.mlp_mult * cfg.d_model)
        dense(f"blocks.{i}.mlp_dn", cfg.mlp_mult * cfg.d_model, cfg.d_model)
    ln("ln_f")
    # int32 buffer: rides through federation untouched, out of W
    params["pos_ids"] = torch.arange(cfg.n_tokens, dtype=torch.int32)
    return {k: v.to(device) for k, v in params.items()}


def _layernorm(x, p, name):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + 1e-5) * p[f"{name}.scale"].float()
            + p[f"{name}.bias"].float())


def _dense(x, p, name):
    return x @ p[f"{name}.w"].float() + p[f"{name}.b"].float()


def _attention(x, p, blk: str, cfg: TinyConfig):
    b, t, d = x.shape
    hd = d // cfg.n_heads
    qkv = _dense(x, p, f"{blk}.qkv").reshape(b, t, 3, cfg.n_heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # (b, t, h, hd)
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    att = torch.softmax(att, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, t, d)
    return _dense(out, p, f"{blk}.attn_out")


def apply(params: dict[str, torch.Tensor], x: torch.Tensor,
          cfg: TinyConfig = TinyConfig()) -> torch.Tensor:
    """x: (B, 28, 28, 1) -> logits (B, n_classes); computed in f32."""
    tok = x.reshape(x.shape[0], cfg.n_tokens, cfg.d_in).float()
    pos = params["pos_table"].float()[params["pos_ids"].long()]
    h = _dense(tok, params, "embed") + pos[None]
    for i in range(cfg.n_blocks):
        blk = f"blocks.{i}"
        h = h + _attention(_layernorm(h, params, f"{blk}.ln1"), params, blk,
                           cfg)
        m = _dense(_layernorm(h, params, f"{blk}.ln2"), params,
                   f"{blk}.mlp_up")
        h = h + _dense(F.gelu(m, approximate="tanh"), params,
                       f"{blk}.mlp_dn")
    h = torch.mean(_layernorm(h, params, "ln_f"), dim=1)   # pool tokens
    return _dense(h, params, "head")


def loss_fn(params: dict[str, torch.Tensor], batch: dict) -> torch.Tensor:
    """Mean softmax cross-entropy on a {'x', 'y'} batch (f32)."""
    return F.cross_entropy(apply(params, batch["x"]), batch["y"].long())


def accuracy(params: dict[str, torch.Tensor], x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(apply(params, x), dim=-1) == y).float())
