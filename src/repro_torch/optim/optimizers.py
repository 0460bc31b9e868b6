"""Minimal functional optimizers over parameter dicts.

API mirrors the reference (and optax): ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (updates, new_state)``; apply with
:func:`apply_updates`.  Pure functions, so they compose with
``torch.func.vmap``.  Ported so far: ``sgd``; ``adam``/``adamw`` wait for
the pretrain slice (ROADMAP queue A item 11).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Params = dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], dict]
    update: Callable[..., tuple[Params, dict]]


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def sgd(lr: float) -> Optimizer:
    """Plain SGD, the paper's local optimizer (no state)."""

    def init(params):
        return {}

    def update(grads, state, params=None):
        return {k: -lr * g for k, g in grads.items()}, state

    return Optimizer(init, update)
