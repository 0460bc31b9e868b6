"""ClientUpdate — local training on a client's private shard (paper §IV.E).

Each communication round every client runs E = 5 local epochs of SGD with
batch size 10 from the broadcast global model.  :func:`client_update` is one
client's run, written as pure functions of its inputs so that
``torch.func.vmap`` over the client axis gives the whole federation's local
phase (:func:`local_phase`).

A shard of n samples takes ``n // bs`` full batches an epoch plus, when
``bs`` does not divide n, one batch of the ``n mod bs`` leftover samples
whose loss is their mean (the reference pads that batch to ``bs`` and masks
the padding, which is the same function).  The epoch loss is the mean over
the epoch's batches, ``(total + tail_loss) / (steps + 1)`` with a tail.

The per-epoch shuffles are an input (``perms``): torch cannot reproduce the
reference's threefry draws, so the parity tests pass the reference's
permutations in and the federation loop draws its own from a
``torch.Generator``.

**Differential privacy** (``dp_clip`` / ``dp_sigma``): :func:`privatize`
clips each client's update delta ω' − θ to global L2 norm ``dp_clip`` and
adds Gaussian noise of std ``dp_sigma * dp_clip`` (``dp_sigma`` with an
infinite clip), the per-client Gaussian mechanism whose composed epsilon
:func:`repro_torch.obs.privacy.gaussian_epsilon` accounts.  The reference
applies it leaf by leaf at the end of each client's update; the port
applies it to the rows of the (N, D) client matrix W, whose columns are the
reference's leaves in its flatten order, so the two are the same function
(the norm sums in another order).  The federation engine calls it after
flattening.  The defaults (clip inf, sigma 0) skip the mechanism: W is
returned as it came.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch.optim import optimizers as opt_mod


class ClientConfig(NamedTuple):
    epochs: int = 5
    batch_size: int = 10
    lr: float = 0.01
    momentum: float = 0.0
    #: L2 clip norm for the reported update delta; inf = no clipping.
    dp_clip: float = float("inf")
    #: Gaussian noise multiplier (noise std = dp_sigma * dp_clip); with an
    #: infinite clip the std is dp_sigma itself (no epsilon guarantee).
    dp_sigma: float = 0.0


def dp_enabled(cfg: ClientConfig) -> bool:
    """True when the config requests the DP mechanism."""
    return cfg.dp_sigma > 0.0 or math.isfinite(cfg.dp_clip)


def validate_dp(cfg: ClientConfig) -> None:
    if cfg.dp_sigma < 0.0 or not math.isfinite(cfg.dp_sigma):
        raise ValueError(f"dp_sigma={cfg.dp_sigma} must be finite and >= 0")
    if not cfg.dp_clip > 0.0:
        raise ValueError(f"dp_clip={cfg.dp_clip} must be > 0")


def privatize(w: torch.Tensor, theta: torch.Tensor, cfg: ClientConfig,
              noise: torch.Tensor | None = None,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """The DP client path on the (N, D) client matrix ``w``.

    Each row's delta from the (D,) broadcast model ``theta`` is scaled by
    ``min(1, dp_clip / max(‖delta‖, 1e-12))`` (the norm accumulated in f32)
    and, when ``dp_sigma > 0``, perturbed with ``noise`` (the (N, D)
    standard normal draws, injected) or draws from ``generator`` on ``w``'s
    device.  Without DP ``w`` comes back untouched.
    """
    if not dp_enabled(cfg):
        return w
    t = theta.to(w.dtype)[None, :]
    d = w - t
    if math.isfinite(cfg.dp_clip):
        norm = torch.sqrt(torch.sum(torch.square(d.float()), dim=1))
        scale = torch.clamp(cfg.dp_clip / torch.clamp(norm, min=1e-12),
                            max=1.0)
        d = d * scale.to(d.dtype)[:, None]
        noise_std = cfg.dp_sigma * cfg.dp_clip
    else:
        noise_std = cfg.dp_sigma
    if cfg.dp_sigma > 0.0:
        if noise is None:
            noise = torch.randn(w.shape, generator=generator,
                                device=w.device, dtype=w.dtype)
        d = d + torch.tensor(noise_std, dtype=d.dtype, device=d.device) * \
            torch.as_tensor(noise, dtype=d.dtype, device=d.device)
    return t + d


def client_update(loss_fn: Callable[[dict, dict], torch.Tensor],
                  params: dict[str, torch.Tensor],
                  data: dict[str, torch.Tensor],
                  perms: torch.Tensor,
                  cfg: ClientConfig) -> tuple[dict[str, torch.Tensor], Any]:
    """Run E local epochs of minibatch SGD from ``params`` on ``data``.

    Args:
      loss_fn: (params, batch) -> scalar loss.
      data: dict of tensors with identical leading dim n
        (e.g. {'x': (n, 28, 28, 1), 'y': (n,)}).
      perms: (E, n) int64, epoch e visits the samples in order ``perms[e]``.

    Returns:
      (new_params, loss of the final epoch)
    """
    n = next(iter(data.values())).shape[0]
    bs = cfg.batch_size
    if n < 1:
        raise ValueError("client shard is empty (n=0): nothing to train on")
    validate_dp(cfg)
    steps = n // bs
    tail = n - steps * bs
    # non-float leaves (position ids, buffers) ride through untouched: only
    # the float ones are differentiated and updated
    buffers = {k: v for k, v in params.items() if not v.is_floating_point()}
    params = {k: v for k, v in params.items() if v.is_floating_point()}
    opt = opt_mod.sgd(cfg.lr, momentum=cfg.momentum)
    opt_state = opt.init(params)
    grad_fn = grad_and_value(lambda p, batch: loss_fn({**p, **buffers},
                                                      batch))

    def step(params, opt_state, idx):
        batch = {key: v[idx] for key, v in data.items()}
        grads, loss = grad_fn(params, batch)
        updates, opt_state = opt.update(grads, opt_state, params)
        return opt_mod.apply_updates(params, updates), opt_state, loss

    epoch_loss = None
    for e in range(cfg.epochs):
        perm = perms[e]
        losses = []
        for s in range(steps):
            params, opt_state, loss = step(params, opt_state,
                                           perm[s * bs:(s + 1) * bs])
            losses.append(loss)
        if tail == 0:
            epoch_loss = torch.mean(torch.stack(losses))
            continue
        total = torch.sum(torch.stack(losses)) if losses else 0.0
        params, opt_state, tail_loss = step(params, opt_state,
                                            perm[steps * bs:])
        epoch_loss = (total + tail_loss) / (steps + 1)
    return {**params, **buffers}, epoch_loss


def local_phase(loss_fn: Callable, global_params: dict[str, torch.Tensor],
                client_data: dict[str, torch.Tensor], perms: torch.Tensor,
                cfg: ClientConfig) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Every client's :func:`client_update` from ``global_params``, vectorized.

    ``client_data`` leaves are (N, n, ...), ``perms`` is (N, E, n).  Returns
    client-stacked params (N, ...) per leaf and the (N,) final-epoch losses.
    """
    return vmap(lambda d, p: client_update(loss_fn, global_params, d, p, cfg),
                randomness="error")(client_data, perms)
