"""Decoder-only LM stack for the dense, MoE, SSM, hybrid and VLM families,
and the decoder of the encoder-decoder family, as ``repro.models.transformer``.

Entry points:
  init(generator, cfg, device)        -> Transformer (an nn.Module)
  forward(model, batch, remat)        -> (logits, moe aux)    train / eval
  loss_fn(model, batch, aux_coef, remat) -> next-token CE + aux_coef * aux
  init_cache(cfg, batch, max_len)     -> cache (a dict of tensors)
  prefill(model, batch, cache)        -> (last logits, cache)
  decode_step(model, token, cache)    -> (logits, cache)

Batch layout: ``{'tokens': (B, S) integer[, 'modal': (B, P, d_modal)]}``.
The VLM and audio frontends are stubs, as in the reference: ``modal``
carries precomputed patch or frame embeddings, which a learned linear
projector maps to d_model; a VLM prepends them to the tokens, the
encoder-decoder family (:mod:`repro_torch.models.encdec`) encodes them into
the decoder's cross-attention memory.

The reference stacks its layers on a leading L axis and scans over them;
here each layer is a :class:`Block` in a ``ModuleList``, run in a Python
loop.  Each block holds its sub-layers' parameters as ``ParameterDict``s
(``attn``, ``ssm``, ``cross``, ``moe``, ``mlp``, ``ln1``, ``ln_cross``,
``ln2``) with the reference's leaf names, dense weights (out, in);
:mod:`repro_torch.carry` moves parameters across.  The decode cache keeps
the reference's stacked layout (``k``, ``v``: (L, B, Hkv, S_max, Dh);
``conv``, ``h``: (L, B, ...); ``memory``; ``index`` a 0-d int32 tensor),
and :func:`prefill` and :func:`decode_step` update its tensors in place.

``remat=True`` checkpoints each block (the reference's ``jax.checkpoint`` of
its layer-scan body): only the blocks' boundary activations persist to the
backward pass, which runs each block's forward again
(:func:`run_blocks`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention_apply, attention_init,
                                       dense_init, dtype_of, mlp_apply,
                                       mlp_init, rmsnorm, rmsnorm_init)


def _param_dict(tensors: dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t) for k, t in tensors.items()})


def run_blocks(blocks, x: torch.Tensor, positions: torch.Tensor, *,
               remat: bool = False, **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """A full-sequence pass through ``blocks``: (x, the sum of their MoE
    aux losses).  ``remat``: each block under
    ``torch.utils.checkpoint.checkpoint`` (non-reentrant), so its inner
    activations are made again in the backward instead of kept."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in blocks:
        if remat:
            x, _, _, a = torch.utils.checkpoint.checkpoint(
                block, x, positions, use_reentrant=False, **kw)
        else:
            x, _, _, a = block(x, positions, **kw)
        aux = aux + a
    return x, aux


class Block(nn.Module):
    """Pre-norm residual block: attention, SSM, or both in parallel
    (hymba); cross-attention on the encoder memory where the block has it;
    then the MoE or the MLP where the family has one."""

    def __init__(self, cfg: ModelConfig, params: dict[str, dict]):
        super().__init__()
        self.cfg = cfg
        for name, tensors in params.items():
            self.add_module(name, _param_dict(tensors))

    def mixer(self, h: torch.Tensor, positions: torch.Tensor, *, cache=None,
              cache_index=None, ssm_state=None, causal: bool = True):
        """Token mixer: (mix, new attention cache, new SSM state)."""
        cfg = self.cfg
        new_cache = new_ssm = None
        outs = []
        if "attn" in self._modules:
            a, new_cache = attention_apply(self.attn, cfg, h,
                                           positions=positions, cache=cache,
                                           cache_index=cache_index,
                                           causal=causal)
            outs.append(a)
        if "ssm" in self._modules:
            if ssm_state is not None and h.shape[1] == 1:
                s, new_ssm = ssm_mod.ssm_step(self.ssm, cfg, h, ssm_state)
            elif ssm_state is not None:
                # a multi-token prefill: the chunked scan from the state
                s, new_ssm = ssm_mod.ssm_apply(self.ssm, cfg, h,
                                               state=ssm_state,
                                               return_state=True)
            else:
                s = ssm_mod.ssm_apply(self.ssm, cfg, h)
            outs.append(s)
        mix = outs[0] if len(outs) == 1 else 0.5 * (outs[0] + outs[1])
        return mix, new_cache, new_ssm

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                cache=None, cache_index=None, ssm_state=None, memory=None,
                causal: bool = True):
        """Returns (x, new attention cache, new SSM state, MoE aux)."""
        cfg = self.cfg
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        mix, new_cache, new_ssm = self.mixer(
            h, positions, cache=cache, cache_index=cache_index,
            ssm_state=ssm_state, causal=causal)
        x = x + mix
        if "cross" in self._modules and memory is not None:
            hc = rmsnorm(self.ln_cross, x, cfg.norm_eps)
            c, _ = attention_apply(self.cross, cfg, hc, positions=positions,
                                   memory=memory)
            x = x + c
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if "moe" in self._modules:
            m, aux = moe_mod.moe_apply(self.moe, cfg,
                                       rmsnorm(self.ln2, x, cfg.norm_eps))
            x = x + m
        elif "mlp" in self._modules:
            x = x + mlp_apply(self.mlp, rmsnorm(self.ln2, x, cfg.norm_eps))
        return x, new_cache, new_ssm, aux


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])      # (padded vocab, d)
        self.ln_f = _param_dict(params["ln_f"])
        self.layers = nn.ModuleList(Block(cfg, p) for p in params["layers"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(params["lm_head"])  # (padded vocab, d)
        if cfg.modality:
            self.proj = nn.Parameter(params["proj"])    # (d, d_modal)
        if cfg.enc_dec:
            from repro_torch.models import encdec

            self.encoder = encdec.Encoder(cfg, params["encoder"])

    def embed_inputs(self, batch: dict) -> tuple[torch.Tensor, int]:
        """Token (+ modal prefix) embeddings: (x (B, S', d), n_prefix)."""
        cfg = self.cfg
        x = F.embedding(batch["tokens"].long(), self.embed)    # (B, S, d)
        if cfg.modality and not cfg.enc_dec and "modal" in batch:
            pre = F.linear(batch["modal"].to(x.dtype), self.proj)
            return torch.cat([pre, x], dim=1), pre.shape[1]
        return x, 0

    def lm_logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rmsnorm(self.ln_f, x, cfg.norm_eps)
        head = self.embed if cfg.tie_embeddings else self.lm_head
        logits = F.linear(x, head)
        if cfg.padded_vocab != cfg.vocab:
            logits = logits[..., :cfg.vocab]
        return logits

    def forward(self, batch: dict, *,
                remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence causal forward: (logits (B, S', vocab), the sum of
        the layers' MoE aux losses); ``remat`` checkpoints each block."""
        if self.cfg.enc_dec:
            from repro_torch.models import encdec

            return encdec.forward(self, batch, remat=remat)
        x, _ = self.embed_inputs(batch)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        x, aux = run_blocks(self.layers, x, positions, remat=remat)
        return self.lm_logits(x), aux


def block_init(generator: torch.Generator, cfg: ModelConfig,
               device: str | torch.device = "cpu", *,
               cross: bool = False) -> dict[str, dict]:
    dt = dtype_of(cfg)
    p: dict[str, dict] = {"ln1": rmsnorm_init(cfg.d_model, dt, device)}
    if not cfg.attn_free:
        p["attn"] = attention_init(generator, cfg, device)
    if cfg.ssm or cfg.hybrid:
        p["ssm"] = ssm_mod.ssm_init(generator, cfg, device)
    if cross:
        p["ln_cross"] = rmsnorm_init(cfg.d_model, dt, device)
        p["cross"] = attention_init(generator, cfg, device)
    if cfg.moe:
        p["ln2"] = rmsnorm_init(cfg.d_model, dt, device)
        p["moe"] = moe_mod.moe_init(generator, cfg, device)
    elif cfg.d_ff > 0 and not cfg.ssm:
        p["ln2"] = rmsnorm_init(cfg.d_model, dt, device)
        p["mlp"] = mlp_init(generator, cfg, device)
    return p


def init(generator: torch.Generator, cfg: ModelConfig,
         device: str | torch.device = "cpu") -> Transformer:
    """The model with the reference's initial distributions, drawn from
    ``generator`` (on its own device) and placed on ``device``.  The draws
    differ from the reference's (torch cannot reproduce threefry): parity
    tests carry the reference's parameters across instead."""
    dt = dtype_of(cfg)
    # GPT-style 0.02 init keeps tied-head logits O(1) after the final norm
    params: dict = {
        "embed": dense_init(generator, cfg.d_model, cfg.padded_vocab, dt,
                            scale=0.02, device=device),
        "ln_f": rmsnorm_init(cfg.d_model, dt, device),
        "layers": [block_init(generator, cfg, device, cross=cfg.enc_dec)
                   for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model,
                                       cfg.padded_vocab, dt, device=device)
    if cfg.modality:
        params["proj"] = dense_init(generator, cfg.d_modal, cfg.d_model, dt,
                                    device=device)
    if cfg.enc_dec:
        from repro_torch.models import encdec

        params["encoder"] = encdec.encoder_init(generator, cfg, device)
    return Transformer(cfg, params)


def forward(model: Transformer, batch: dict, *,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward: (logits (B, S', vocab), MoE aux);
    ``remat`` checkpoints each block."""
    return model(batch, remat=remat)


def loss_fn(model: Transformer, batch: dict, *, aux_coef: float = 0.01,
            remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy in f32 over the text positions (logsumexp
    after the one-token shift), plus ``aux_coef`` times the MoE aux loss;
    ``remat`` checkpoints each block."""
    logits, aux = forward(model, batch, remat=remat)
    tokens = batch["tokens"]
    n_prefix = logits.shape[1] - tokens.shape[1]
    lg = logits[:, n_prefix:-1].float()
    tg = tokens[:, 1:].long()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tg[..., None])[..., 0]
    return torch.mean(logz - gold) + aux_coef * aux


# --- serving ----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None, *, ring: bool = False,
               device: str | torch.device = "cpu") -> dict:
    """The stacked (leading L) decode state, zeros, ``index`` 0.

    ``ring=True`` (sliding-window archs only): a ``window``-slot ring
    buffer instead of the full timeline, O(window) memory for any length.
    """
    dt = dtype or dtype_of(cfg)
    n = cfg.n_layers
    cache: dict = {"index": torch.zeros((), dtype=torch.int32, device=device)}
    if not cfg.attn_free:
        kv_len = max_len
        if ring and cfg.window is not None:
            kv_len = min(max_len, cfg.window)
        kv = (n, batch, cfg.n_kv_heads, kv_len, cfg.head_dim)
        cache["k"] = torch.zeros(kv, dtype=dt, device=device)
        cache["v"] = torch.zeros(kv, dtype=dt, device=device)
    if cfg.ssm or cfg.hybrid:
        cache["conv"] = torch.zeros((n, batch, cfg.ssm_conv - 1, cfg.d_inner),
                                    dtype=dt, device=device)
        cache["h"] = torch.zeros((n, batch, cfg.d_inner, cfg.ssm_state),
                                 dtype=torch.float32, device=device)
    if cfg.enc_dec:
        cache["memory"] = torch.zeros((batch, cfg.n_modal_tokens, cfg.d_model),
                                      dtype=dt, device=device)
    return cache


def _step(model: Transformer, x: torch.Tensor, cache: dict,
          positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Advance the layer stack by x's token(s) with the cached state: each
    layer's K/V slice and SSM state are updated in place.  Returns x and a
    new dict over the same tensors with the index advanced."""
    idx = cache["index"]
    memory = cache.get("memory")
    for i, block in enumerate(model.layers):
        attn_cache = ({"k": cache["k"][i], "v": cache["v"][i]}
                      if "k" in cache else None)
        ssm_state = ({"conv": cache["conv"][i], "h": cache["h"][i]}
                     if "conv" in cache else None)
        x, _, new_ssm, _ = block(x, positions, cache=attn_cache,
                                 cache_index=idx, ssm_state=ssm_state,
                                 memory=memory)
        if new_ssm is not None:
            cache["conv"][i].copy_(new_ssm["conv"])
            cache["h"][i].copy_(new_ssm["h"])
    new_cache = dict(cache)
    new_cache["index"] = idx + x.shape[1]
    return x, new_cache


def prefill(model: Transformer, batch: dict,
            cache: dict) -> tuple[torch.Tensor, dict]:
    """Run the prompt (and a VLM's modal prefix) through the stack, filling
    the cache.  Returns the last position's logits (B, vocab) and the
    cache."""
    if model.cfg.enc_dec:
        from repro_torch.models import encdec

        return encdec.prefill(model, batch, cache)
    x, _ = model.embed_inputs(batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s) + cache["index"]
    x, cache = _step(model, x, cache, positions)
    return model.lm_logits(x[:, -1:])[:, 0], cache


def decode_step(model: Transformer, token: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: (B,) or (B, 1) integer -> (logits (B,
    vocab), cache)."""
    if token.dim() == 1:
        token = token[:, None]
    x = F.embedding(token.long(), model.embed)                # (B, 1, d)
    positions = cache["index"].expand(x.shape[0], 1)
    x, cache = _step(model, x, cache, positions)
    return model.lm_logits(x)[:, 0], cache
