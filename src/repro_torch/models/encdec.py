"""Encoder-decoder backbone (seamless-m4t-large-v2's transformer), as
``repro.models.encdec``.

The modality frontend (mel spectrogram and conformer feature extractor) is
a stub, as in the reference: the batch supplies precomputed frame
embeddings (B, T, d_modal), a learned linear projector lifts them to
d_model, and a bidirectional transformer encoder (its blocks run with
``causal=False``: through the flash kernel when
:data:`repro_torch.models.layers.USE_FLASH_KERNEL` is set) makes the
cross-attention memory.  The decoder is the stack of
:mod:`repro_torch.models.transformer`, each block with cross-attention.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, dtype_of, rmsnorm,
                                       rmsnorm_init)


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, enc_dec=False, n_layers=cfg.n_enc_layers,
                               modality=None)


def encoder_init(generator: torch.Generator, cfg: ModelConfig,
                 device: str | torch.device = "cpu") -> dict:
    """The projector (d, d_modal), the encoder's blocks and its final norm."""
    ecfg = _enc_cfg(cfg)
    dt = dtype_of(cfg)
    return {
        "proj": dense_init(generator, cfg.d_modal, cfg.d_model, dt,
                           device=device),
        "layers": [tf.block_init(generator, ecfg, device)
                   for _ in range(ecfg.n_layers)],
        "ln_f": rmsnorm_init(cfg.d_model, dt, device),
    }


class Encoder(nn.Module):
    """modal (B, T, d_modal) frame embeddings -> memory (B, T, d)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = _enc_cfg(cfg)
        self.proj = nn.Parameter(params["proj"])
        self.layers = nn.ModuleList(tf.Block(self.cfg, p)
                                    for p in params["layers"])
        self.ln_f = tf._param_dict(params["ln_f"])

    def forward(self, modal: torch.Tensor, *,
                remat: bool = False) -> torch.Tensor:
        x = F.linear(modal.to(self.proj.dtype), self.proj)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        x, _ = tf.run_blocks(self.layers, x, positions, remat=remat,
                             causal=False)
        return rmsnorm(self.ln_f, x, self.cfg.norm_eps)


def encode(model: tf.Transformer, modal: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """The encoder memory of ``modal`` (B, T, d_modal): (B, T, d);
    ``remat`` checkpoints each encoder block."""
    return model.encoder(modal, remat=remat)


def forward(model: tf.Transformer, batch: dict, *,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward: encode the modal frames, decode the tokens with
    cross-attention.  Returns (logits, MoE aux); ``remat`` checkpoints each
    encoder and decoder block."""
    memory = encode(model, batch["modal"], remat=remat)
    x = F.embedding(batch["tokens"].long(), model.embed)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, aux = tf.run_blocks(model.layers, x, positions, remat=remat,
                           memory=memory)
    return model.lm_logits(x), aux


def prefill(model: tf.Transformer, batch: dict,
            cache: dict) -> tuple[torch.Tensor, dict]:
    """Encode the memory into the cache (in place), then prefill the
    decoder's prompt.  Returns the last position's logits and the cache."""
    cache["memory"].copy_(encode(model, batch["modal"]))
    x = F.embedding(batch["tokens"].long(), model.embed)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s) + cache["index"]
    x, cache = tf._step(model, x, cache, positions)
    return model.lm_logits(x[:, -1:])[:, 0], cache
