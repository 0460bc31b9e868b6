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

The DP path (``dp_clip`` / ``dp_sigma``) waits for the simulation and
privacy slice (ROADMAP queue A.3c); asking for it raises.
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
    #: L2 clip norm for the reported update delta; inf = no clipping.
    dp_clip: float = float("inf")
    #: Gaussian noise multiplier of the DP path; 0 = no noise.
    dp_sigma: float = 0.0


def dp_enabled(cfg: ClientConfig) -> bool:
    """True when the config requests the DP mechanism."""
    return cfg.dp_sigma > 0.0 or math.isfinite(cfg.dp_clip)


def validate_dp(cfg: ClientConfig) -> None:
    if dp_enabled(cfg):
        raise NotImplementedError(
            "the DP client path waits for the simulation and privacy slice "
            "(ROADMAP queue A.3c)")


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
    opt = opt_mod.sgd(cfg.lr)
    opt_state = opt.init(params)
    grad_fn = grad_and_value(loss_fn)

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
    return params, epoch_loss


def local_phase(loss_fn: Callable, global_params: dict[str, torch.Tensor],
                client_data: dict[str, torch.Tensor], perms: torch.Tensor,
                cfg: ClientConfig) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Every client's :func:`client_update` from ``global_params``, vectorized.

    ``client_data`` leaves are (N, n, ...), ``perms`` is (N, E, n).  Returns
    client-stacked params (N, ...) per leaf and the (N,) final-epoch losses.
    """
    return vmap(lambda d, p: client_update(loss_fn, global_params, d, p, cfg),
                randomness="error")(client_data, perms)
