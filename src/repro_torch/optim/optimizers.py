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

``lr`` may be a float or a ``step -> lr`` schedule
(:mod:`repro_torch.optim.schedules`); with a schedule every optimizer
counts its steps in the state.  :func:`chain` puts a gradient
transformation such as :func:`clip_by_global_norm` in front of an
optimizer.
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


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """SGD with optional (Nesterov) momentum.  Without momentum and with a
    float ``lr`` it is the paper's local optimizer and has no state; the
    momentum buffers keep each parameter's dtype, as in the reference.  A
    schedule is read at the step count before the step, as the
    reference's ``sgd`` reads it."""
    if callable(lr):
        def advance(state):
            return {"lr": lr(state["step"])}, {"step": state["step"] + 1}
        counter = {"step": 0}
    else:
        def advance(state):
            return {"lr": lr}, {}
        counter = {}
    if momentum == 0.0:
        return _optimizer(lambda params: dict(counter), (), advance,
                          lambda g, p, s, c: (-c["lr"] * g, {}))

    def leaf(g, p, s, c):
        mu = momentum * s["mu"] + g
        rate = c["lr"]
        return -rate * (momentum * mu + g if nesterov else mu), {"mu": mu}

    return _optimizer(
        lambda params: {"mu": {k: torch.zeros_like(p)
                               for k, p in params.items()}, **counter},
        ("mu",), advance, leaf)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam / AdamW (decoupled weight decay when weight_decay > 0).  The
    bias corrections are computed in f32, as the reference computes them;
    a schedule is read at the step count after the step."""

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
                 "bc2": float(f32(1) - f32(b2) ** f32(step)),
                 "lr": lr(step) if callable(lr) else lr},
                {"step": step})

    def leaf(g, p, s, c):
        g = g.float()
        m = b1 * s["m"] + (1 - b1) * g
        v = b2 * s["v"] + (1 - b2) * torch.square(g)
        rate = c["lr"]
        upd = -rate * (m / c["bc1"]) / (torch.sqrt(v / c["bc2"]) + eps)
        if weight_decay:
            upd = upd - rate * weight_decay * p.float()
        return upd, {"m": m, "v": v}

    return _optimizer(init, ("m", "v"), advance, leaf)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def clip_by_global_norm(max_norm: float) -> Callable[[Params], Params]:
    """Gradient transformation: scale a gradient dict to a global L2 norm
    of at most ``max_norm`` (the norm accumulated in f32)."""

    def clip(grads):
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads.values()))
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return {k: g * scale.to(g.dtype) for k, g in grads.items()}

    return clip


def chain(transform: Callable[[Params], Params], opt: Optimizer) -> Optimizer:
    """Apply a gradient transformation (e.g. clipping) before an
    optimizer, in ``update`` and in ``step`` alike."""

    def update(grads, state, params=None):
        return opt.update(transform(grads), state, params)

    def step(params, grads, state):
        opt.step(params, transform(grads), state)

    return Optimizer(opt.init, update, step)
