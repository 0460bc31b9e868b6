"""Architecture configuration shared by the whole model zoo (a copy of
``repro.models.config``).

One frozen dataclass covers all six assigned families (dense / moe / ssm /
hybrid / vlm / audio); family-specific fields are ignored elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                   # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int                      # dense-MLP hidden (for MoE: per-expert)
    vocab: int
    d_head: int = 0                # 0 -> d_model // n_heads

    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba-1) ---
    ssm: bool = False              # all layers SSM (falcon-mamba)
    hybrid: bool = False           # parallel attn+SSM heads (hymba)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)

    # --- attention details ---
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0     # chatglm3 "2d RoPE": 0.5 (partial rotary)
    window: Optional[int] = None   # sliding-window attention
    mlp: str = "swiglu"            # swiglu | gelu
    qkv_bias: bool = False

    # --- encoder-decoder (seamless-m4t backbone) ---
    enc_dec: bool = False
    n_enc_layers: int = 0

    # --- modality frontend stub (vlm/audio) ---
    modality: Optional[str] = None # vision | audio
    n_modal_tokens: int = 0        # patches / frames provided by the stub
    d_modal: int = 0               # frontend embedding width (projector input)

    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"        # param/activation dtype name
    vocab_pad: int = 1             # pad embed rows to a multiple (sharding);
                                   # logits are sliced back to `vocab`

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // self.vocab_pad) * self.vocab_pad

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def attn_free(self) -> bool:
        return self.ssm and not self.hybrid

    def n_params(self) -> int:
        """Analytic total parameter count (embeddings included once if tied)."""
        d, ff, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        dh, hq, hkv = self.head_dim, self.n_heads, self.n_kv_heads
        per_layer = 0
        if not self.attn_free:
            per_layer += d * hq * dh + 2 * d * hkv * dh + hq * dh * d  # qkvo
        if self.ssm or self.hybrid:
            di, st, dr = self.d_inner, self.ssm_state, self.dt_rank_
            per_layer += (d * 2 * di + di * self.ssm_conv +
                          di * (dr + 2 * st) + dr * di + di * st + di + di * d)
        if self.moe:
            per_layer += d * self.n_experts                      # router
            per_layer += self.n_experts * 3 * d * ff             # swiglu experts
        elif not self.ssm:
            mult = 3 if self.mlp == "swiglu" else 2
            per_layer += mult * d * ff
        per_layer += 2 * d                                       # norms
        total = L * per_layer + v * d + d                        # embed + final norm
        if not self.tie_embeddings:
            total += v * d
        if self.enc_dec:
            enc_layer = (d * hq * dh + 2 * d * hkv * dh + hq * dh * d
                         + (3 if self.mlp == "swiglu" else 2) * d * ff + 2 * d)
            cross = d * hq * dh + 2 * d * hkv * dh + hq * dh * d + d
            total += self.n_enc_layers * enc_layer + L * cross
        if self.modality:
            total += self.d_modal * self.d_model                 # projector stub
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.n_params()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        inactive = L * (self.n_experts - self.top_k) * 3 * d * ff
        return self.n_params() - inactive
