"""Decoder-only LM stack for the dense, SSM and hybrid families, the
training path of ``repro.models.transformer``.

Entry points:
  init(generator, cfg, device)  -> Transformer (an nn.Module)
  forward(model, batch)         -> logits (B, S, vocab)
  loss_fn(model, batch)         -> scalar next-token cross-entropy

Batch layout: ``{'tokens': (B, S) integer}``.  The reference stacks its
layers on a leading L axis and scans over them; here each layer is a
:class:`Block` in a ``ModuleList``, run in a Python loop.  Each block holds
its sub-layers' parameters as ``ParameterDict``s (``attn``, ``ssm``,
``mlp``, ``ln1``, ``ln2``) with the reference's leaf names, dense weights
(out, in); :mod:`repro_torch.carry` moves parameters across.

The ``moe``, ``vlm`` and ``audio``/encoder-decoder families raise
``NotImplementedError``: they are ported with the rest of ROADMAP queue
A.4, as are the cache, ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention_apply, attention_init,
                                       dense_init, dtype_of, mlp_apply,
                                       mlp_init, rmsnorm, rmsnorm_init)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families this slice of the port does not run."""
    for flag, family in ((cfg.moe, "moe"), (cfg.enc_dec, "encoder-decoder"),
                         (cfg.modality is not None, cfg.modality)):
        if flag:
            raise NotImplementedError(
                f"{cfg.name}: the {family} family is not ported yet "
                f"(ROADMAP queue A.4)")


def _param_dict(tensors: dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t) for k, t in tensors.items()})


class Block(nn.Module):
    """Pre-norm residual block: attention, SSM, or both in parallel
    (hymba), then the MLP where the family has one."""

    def __init__(self, cfg: ModelConfig, params: dict[str, dict]):
        super().__init__()
        self.cfg = cfg
        for name, tensors in params.items():
            self.add_module(name, _param_dict(tensors))

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        outs = []
        if "attn" in self._modules:
            outs.append(attention_apply(self.attn, cfg, h,
                                        positions=positions))
        if "ssm" in self._modules:
            outs.append(ssm_mod.ssm_apply(self.ssm, cfg, h))
        x = x + (outs[0] if len(outs) == 1 else 0.5 * (outs[0] + outs[1]))
        if "mlp" in self._modules:
            x = x + mlp_apply(self.mlp, rmsnorm(self.ln2, x, cfg.norm_eps))
        return x


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])      # (padded vocab, d)
        self.ln_f = _param_dict(params["ln_f"])
        self.layers = nn.ModuleList(Block(cfg, p) for p in params["layers"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(params["lm_head"])  # (padded vocab, d)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = F.embedding(tokens.long(), self.embed)            # (B, S, d)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        for block in self.layers:
            x = block(x, positions)
        x = rmsnorm(self.ln_f, x, cfg.norm_eps)
        head = self.embed if cfg.tie_embeddings else self.lm_head
        logits = F.linear(x, head)
        if cfg.padded_vocab != cfg.vocab:
            logits = logits[..., :cfg.vocab]
        return logits


def block_init(generator: torch.Generator, cfg: ModelConfig,
               device: str | torch.device = "cpu") -> dict[str, dict]:
    dt = dtype_of(cfg)
    p: dict[str, dict] = {"ln1": rmsnorm_init(cfg.d_model, dt, device)}
    if not cfg.attn_free:
        p["attn"] = attention_init(generator, cfg, device)
    if cfg.ssm or cfg.hybrid:
        p["ssm"] = ssm_mod.ssm_init(generator, cfg, device)
    if cfg.d_ff > 0 and not cfg.ssm:
        p["ln2"] = rmsnorm_init(cfg.d_model, dt, device)
        p["mlp"] = mlp_init(generator, cfg, device)
    return p


def init(generator: torch.Generator, cfg: ModelConfig,
         device: str | torch.device = "cpu") -> Transformer:
    """The model with the reference's initial distributions, drawn from
    ``generator`` (on its own device) and placed on ``device``.  The draws
    differ from the reference's (torch cannot reproduce threefry): parity
    tests carry the reference's parameters across instead."""
    check_supported(cfg)
    dt = dtype_of(cfg)
    # GPT-style 0.02 init keeps tied-head logits O(1) after the final norm
    params: dict = {
        "embed": dense_init(generator, cfg.d_model, cfg.padded_vocab, dt,
                            scale=0.02, device=device),
        "ln_f": rmsnorm_init(cfg.d_model, dt, device),
        "layers": [block_init(generator, cfg, device)
                   for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model,
                                       cfg.padded_vocab, dt, device=device)
    return Transformer(cfg, params)


def forward(model: Transformer, batch: dict) -> torch.Tensor:
    """Full-sequence causal forward: logits (B, S, vocab)."""
    return model(batch["tokens"])


def loss_fn(model: Transformer, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy in f32 (logsumexp after the one-token
    shift).  The reference adds a MoE auxiliary loss, which is 0 for the
    families ported here."""
    logits = forward(model, batch)
    tokens = batch["tokens"]
    lg = logits[:, :-1].float()
    tg = tokens[:, 1:].long()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tg[..., None])[..., 0]
    return torch.mean(logz - gold)
