"""Architecture registry: ``--arch <id>`` resolution + reduced smoke variants."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (chatglm3_6b, falcon_mamba_7b, hymba_1_5b,
                           kimi_k2_1t_a32b, moonshot_v1_16b_a3b,
                           phi3_5_moe_42b_a6_6b, phi3_medium_14b,
                           phi_3_vision_4_2b, seamless_m4t_large_v2,
                           starcoder2_7b)
from repro_torch.models.config import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        chatglm3_6b.CONFIG,
        moonshot_v1_16b_a3b.CONFIG,
        phi_3_vision_4_2b.CONFIG,
        phi3_medium_14b.CONFIG,
        falcon_mamba_7b.CONFIG,
        hymba_1_5b.CONFIG,
        phi3_5_moe_42b_a6_6b.CONFIG,
        kimi_k2_1t_a32b.CONFIG,
        starcoder2_7b.CONFIG,
        seamless_m4t_large_v2.CONFIG,
    ]
}

# beyond-paper variants (not part of the assigned 10, selectable explicitly)
EXTRA_ARCHS: dict[str, ModelConfig] = {
    starcoder2_7b.SWA_CONFIG.name: starcoder2_7b.SWA_CONFIG,
}

ASSIGNED = list(ARCHS)


def get(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in EXTRA_ARCHS:
        return EXTRA_ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS) + sorted(EXTRA_ARCHS)}")


def reduced(cfg: ModelConfig, *, d_model: int = 256, n_layers: int = 2,
            vocab: int = 512) -> ModelConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=512,
    <=4 experts, tiny vocab/frontend, float32 for CPU numerics."""
    heads = 4 if cfg.n_heads else 0
    kv = max(1, (heads * cfg.n_kv_heads) // max(cfg.n_heads, 1)) if heads else 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=kv,
        d_head=(d_model // heads if heads else 0),
        d_ff=(min(cfg.d_ff, 2 * d_model) if cfg.d_ff else 0),
        vocab=vocab,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        window=(32 if cfg.window is not None else None),
        n_enc_layers=(n_layers if cfg.enc_dec else 0),
        n_modal_tokens=(8 if cfg.modality else 0),
        d_modal=(32 if cfg.modality else 0),
        dtype="float32",
    )
