"""Learning-rate schedules (``step -> lr`` callables, f32 0-d tensors).

A copy of ``repro.optim.schedules``: ``step`` is an int or an integer
tensor, and the arithmetic runs in f32 as the reference's does.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        frac = torch.clamp(_f32(step) / max(warmup_steps, 1), max=1.0)
        return lr * frac
    return f


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def f(step):
        t = torch.clamp(_f32(step) / decay_steps, max=1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * ((1 - alpha) * cos + alpha)
    return f


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  alpha: float = 0.0):
    def f(step):
        s = _f32(step)
        warm = lr * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps)
                        / max(decay_steps - warmup_steps, 1), 0.0, 1.0)
        cos = lr * ((1 - alpha) * 0.5 * (1 + torch.cos(math.pi * t)) + alpha)
        return torch.where(s < warmup_steps, warm, cos)
    return f
