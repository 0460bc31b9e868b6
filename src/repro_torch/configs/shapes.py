"""The four assigned input shapes and their stand-in inputs (the
reference's ``repro.configs.shapes``).

``input_specs(cfg, shape)`` returns a stand-in for every input of the
matching step function: tensors without storage, the way the dry-run
traces a step with no memory and no card.  By default they are ``meta``
tensors; built under a ``FakeTensorMode`` that the caller has entered,
they are that mode's FakeTensors on ``device``.  The caches come from the
port's own :func:`repro_torch.models.transformer.init_cache`, as the
reference builds them with ``eval_shape``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of


class InputShape(NamedTuple):
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def batch_specs(cfg: ModelConfig, shape: InputShape, *,
                device: str | torch.device = "meta") -> dict:
    """Token (+ modal) batch stand-ins for train and prefill."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _empty((b, s), torch.int32, device)}
    if cfg.modality:
        specs["modal"] = _empty((b, cfg.n_modal_tokens, cfg.d_modal),
                                dtype_of(cfg), device)
    return specs


def cache_specs(cfg: ModelConfig, shape: InputShape, *, ring: bool = False,
                device: str | torch.device = "meta") -> dict:
    """Decode-cache stand-ins sized to the shape's seq_len (+ the modal
    prefix for decoder-only VLMs, whose patch embeddings occupy cache
    slots).  ``ring=True``: the sliding-window ring buffer (window-sized
    KV)."""
    max_len = shape.seq_len
    if cfg.modality and not cfg.enc_dec:
        max_len += cfg.n_modal_tokens
    return transformer.init_cache(cfg, shape.global_batch, max_len,
                                  ring=ring, device=device)


def input_specs(cfg: ModelConfig, shape_name: str, *, ring: bool = False,
                device: str | torch.device = "meta") -> dict:
    """All inputs of the (arch, shape) step function, as stand-ins.

    train:    {'batch': {...}}
    prefill:  {'batch': {...}, 'cache': {...}}
    decode:   {'token': (B,), 'cache': {...}}

    ``ring=True`` swaps decode caches for sliding-window ring buffers
    (windowed archs only; no-op otherwise).  An encoder-decoder's memory
    lives inside its cache.
    """
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, device=device)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, shape, device=device),
                "cache": cache_specs(cfg, shape, device=device)}
    return {"token": _empty((shape.global_batch,), torch.int32, device),
            "cache": cache_specs(cfg, shape, ring=ring, device=device)}


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """Whether this (arch, shape) pair runs, per DESIGN.md
    §Arch-applicability: ``long_500k`` needs sub-quadratic attention."""
    if shape_name == "long_500k":
        subquadratic = cfg.ssm or cfg.hybrid or cfg.window is not None
        if not subquadratic:
            return False, ("full-attention arch: 524k decode requires "
                           "sub-quadratic attention (see DESIGN.md)")
    return True, ""
