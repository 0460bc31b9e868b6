"""Step functions (``repro.launch.steps``).

  make_train_step    — loss, gradient, and an SGD-momentum or Adam update,
                       each block rematerialised by default
  make_prefill_step  — prompt -> filled cache + last-position logits
  make_decode_step   — one new token against the cache
  make_fl_round_step — the paper's technique as one step: vmapped local
                       client steps -> (N, D) weight matrix -> coalition
                       round -> θ in every client slot, the clients and
                       the matrix's columns split over a mesh if one is
                       given
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import pytree, strategies
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import optimizers as opt_mod


def make_train_step(cfg: ModelConfig, *, optimizer: str = "sgd",
                    lr: float = 1e-3,
                    remat: bool = True) -> tuple[Callable, opt_mod.Optimizer]:
    """``train_step(model, opt_state, batch) -> loss``: one step that
    updates the model's parameters and ``opt_state`` in place (the
    optimizer's ``step``); ``optimizer`` is ``adam``, or SGD with momentum
    0.9 for any other name, as in the reference.  ``remat`` (the
    reference's default) checkpoints each block: the backward runs each
    block's forward again instead of keeping its activations."""
    opt = (opt_mod.adam(lr) if optimizer == "adam"
           else opt_mod.sgd(lr, momentum=0.9))

    def train_step(model: tf.Transformer, opt_state: dict,
                   batch: dict) -> torch.Tensor:
        params = dict(model.named_parameters())
        loss = tf.loss_fn(model, batch, remat=remat)
        # a parameter the loss does not read (the encoder-decoder family's
        # top-level modal projector; its encoder has its own) gets a zero
        # gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
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


def _to_column_tiles(rows: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(N / P, D) row blocks, one a rank, -> this rank's (N, D_pad / P)
    column tile (D zero-padded to a multiple of P), rows in rank order: an
    all-to-all over ``axis``."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    parts = dist.get_world_size(group)
    n_loc, d = rows.shape
    width = -(-d // parts)
    if width * parts != d:
        rows = torch.nn.functional.pad(rows, (0, width * parts - d))
    send = rows.reshape(n_loc, parts, width).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.reshape(parts * n_loc, width)


def make_fl_round_step(loss_fn: Callable, template: dict, *,
                       n_coalitions: int, lr: float = 0.01,
                       local_steps: int = 1, backend: str = "stream",
                       wdtype: torch.dtype = torch.float32, wspec=None,
                       shardmap_mesh=None, client_axis: str = "data",
                       strategy=None) -> Callable:
    """One federated round as one step (the reference's
    ``make_fl_round_step``).

    Args:
      loss_fn: ``(params, batch) -> scalar`` of the client model.
      template: one client's parameter dict (its shapes and dtypes).
      n_coalitions, backend: the default strategy, the paper's
        ``coalition`` rule (``stream``, ``dot`` or ``cuda``).
      strategy: a :class:`repro_torch.core.strategies.Strategy` instead.
      lr, local_steps: each client's plain SGD steps on its batch.
      wdtype: the (N, D) weight matrix's dtype (bf16 halves its bytes).
      wspec: the matrix's spec under ``shardmap_mesh``, ``(None, axis)``:
        the mesh axis its columns split over (default ``client_axis``).
      shardmap_mesh: a DeviceMesh.  Each rank then takes its block of
        N / P clients (the clients split over ``client_axis``), trains
        them, and an all-to-all turns the row blocks into column tiles for
        the sharded round (:mod:`repro_torch.core.sharded`); θ is gathered
        from the tiles.  Without it one process takes all N.

    Returns ``fl_round(client_params, client_batch, state) -> (client
    params with θ in every slot, the new strategy state, the assignment,
    the counts)``: client params and batches stacked on a leading client
    axis (a rank's block under a mesh), ``state`` the strategy's state.
    """
    # W's columns: the template's own leaves in order, as they are
    layout = tuple((k, k, None) for k in template)
    d = pytree.flatten(template, layout).shape[0]

    def one_client(params, batch):
        for _ in range(local_steps):
            g = torch.func.grad(loss_fn)(params, batch)
            params = {k: p - lr * g[k] for k, p in params.items()}
        return params

    d_axis = client_axis if wspec is None else wspec[-1]

    def strategy_for(n: int):
        strat = strategy if strategy is not None else \
            strategies.make_strategy("coalition", n_clients=n,
                                     n_coalitions=n_coalitions,
                                     backend=backend)
        if shardmap_mesh is None:
            return strat
        if getattr(strat, "backend", None) is None:
            raise ValueError("make_fl_round_step over a mesh takes a "
                             "coalition rule (a strategy with a backend)")
        from repro_torch.core import sharded

        return dataclasses.replace(strat, backend=sharded.sharded_backend(
            strat.backend, shardmap_mesh, axis=d_axis, tiled_d=d))

    def fl_round(client_params: dict, client_batch: dict, state):
        new = torch.func.vmap(one_client)(client_params, client_batch)
        w = pytree.client_matrix(new, layout, dtype=wdtype)     # (N, D)
        if shardmap_mesh is not None:
            w = _to_column_tiles(w, shardmap_mesh, d_axis)
        res = strategy_for(w.shape[0]).round(w, state)
        theta = res.theta
        if shardmap_mesh is not None:
            from repro_torch.core import sharded

            theta = sharded.gather_cols(theta, shardmap_mesh, d, d_axis)
        one = pytree.unflatten(theta, layout, template)
        n = next(iter(client_params.values())).shape[0]
        broadcast = {k: v[None].expand(n, *v.shape).contiguous()
                     for k, v in one.items()}
        return broadcast, res.state, res.metrics.assignment, \
            res.metrics.counts

    return fl_round
