"""Minimal optimizers over parameter dicts.

API mirrors the reference (and optax): ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (updates, new_state)``, pure, so it
composes with ``torch.func.vmap``; apply with :func:`apply_updates`.
``opt.step(params, grads, state)`` gives the same result in place, one
parameter at a time: the parameters and the state dict are updated, and at
most one parameter's temporaries exist at once (the LM pretraining step
uses it: a pure Adam update of a 1.6B-parameter model would hold two
copies of m and v and a full f32 update).  Adam's m and v are f32 whatever
the parameters' dtype, as in the reference.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

Params = dict[str, torch.Tensor]
#: (gradient, parameter, this parameter's state slots, the step's scalars)
#: -> (update, new slots)
LeafRule = Callable[[torch.Tensor, torch.Tensor, dict, dict],
                    tuple[torch.Tensor, dict]]


class Optimizer(NamedTuple):
    init: Callable[[Params], dict]
    update: Callable[..., tuple[Params, dict]]
    step: Callable[[Params, Params, dict], None]


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def _optimizer(init: Callable[[Params], dict], slots: tuple[str, ...],
               advance: Callable[[dict], tuple[dict, dict]],
               leaf: LeafRule) -> Optimizer:
    """An optimizer from its per-parameter rule.  ``slots`` name the
    per-parameter state dicts; ``advance(state) -> (scalars, new
    counters)`` runs once a step."""

    def update(grads, state, params=None):
        scalars, counters = advance(state)
        new = {s: {} for s in slots}
        updates = {}
        for k, g in grads.items():
            updates[k], out = leaf(g, None if params is None else params[k],
                                   {s: state[s][k] for s in slots}, scalars)
            for s in slots:
                new[s][k] = out[s]
        return updates, {**counters, **new}

    @torch.no_grad()
    def step(params, grads, state):
        scalars, counters = advance(state)
        state.update(counters)
        for k, p in params.items():
            u, out = leaf(grads[k], p, {s: state[s][k] for s in slots},
                          scalars)
            for s in slots:
                state[s][k] = out[s]
            p.copy_((p + u).to(p.dtype))

    return Optimizer(init, update, step)


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """SGD with optional (Nesterov) momentum.  Without momentum it is the
    paper's local optimizer and has no state; the momentum buffers keep each
    parameter's dtype, as in the reference."""
    if momentum == 0.0:
        return _optimizer(lambda params: {}, (), lambda state: ({}, {}),
                          lambda g, p, s, c: (-lr * g, {}))

    def leaf(g, p, s, c):
        mu = momentum * s["mu"] + g
        return -lr * (momentum * mu + g if nesterov else mu), {"mu": mu}

    return _optimizer(
        lambda params: {"mu": {k: torch.zeros_like(p)
                               for k, p in params.items()}},
        ("mu",), lambda state: ({}, {}), leaf)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam / AdamW (decoupled weight decay when weight_decay > 0).  The
    bias corrections are computed in f32, as the reference computes them."""

    def init(params):
        return {"m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()},
                "v": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()},
                "step": 0}

    def advance(state):
        step = state["step"] + 1
        f32 = np.float32
        return ({"bc1": float(f32(1) - f32(b1) ** f32(step)),
                 "bc2": float(f32(1) - f32(b2) ** f32(step))},
                {"step": step})

    def leaf(g, p, s, c):
        g = g.float()
        m = b1 * s["m"] + (1 - b1) * g
        v = b2 * s["v"] + (1 - b2) * torch.square(g)
        upd = -lr * (m / c["bc1"]) / (torch.sqrt(v / c["bc2"]) + eps)
        if weight_decay:
            upd = upd - lr * weight_decay * p.float()
        return upd, {"m": m, "v": v}

    return _optimizer(init, ("m", "v"), advance, leaf)


def adamw(lr: float, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)
