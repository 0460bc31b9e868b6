"""Step functions of the LM path (``repro.launch.steps``).

  make_train_step   — loss, gradient, and an SGD-momentum or Adam update
  make_prefill_step — prompt -> filled cache + last-position logits
  make_decode_step  — one new token against the cache

The FL-round step waits for the sharding slice (ROADMAP queue A.6).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import optimizers as opt_mod


def make_train_step(cfg: ModelConfig, *, optimizer: str = "sgd",
                    lr: float = 1e-3) -> tuple[Callable, opt_mod.Optimizer]:
    """``train_step(model, opt_state, batch) -> loss``: one step that
    updates the model's parameters and ``opt_state`` in place (the
    optimizer's ``step``); ``optimizer`` is ``adam``, or SGD with momentum
    0.9 for any other name, as in the reference."""
    opt = (opt_mod.adam(lr) if optimizer == "adam"
           else opt_mod.sgd(lr, momentum=0.9))

    def train_step(model: tf.Transformer, opt_state: dict,
                   batch: dict) -> torch.Tensor:
        params = dict(model.named_parameters())
        loss = tf.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        opt.step(params, dict(zip(params, grads)), opt_state)
        return loss.detach()

    return train_step, opt


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``prefill_step(model, batch, cache) -> (logits, cache)``."""
    def prefill_step(model: tf.Transformer, batch: dict, cache: dict):
        return tf.prefill(model, batch, cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``decode_step(model, token, cache) -> (logits, cache)``."""
    def decode_step(model: tf.Transformer, token: torch.Tensor, cache: dict):
        return tf.decode_step(model, token, cache)

    return decode_step
