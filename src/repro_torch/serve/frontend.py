"""Batched coalition-routed inference with hot-swappable weights.

A batch of queries arrives, each tagged with the client id it came from;
per the routing table some queries are answered by coalition 0's
barycenter, others by coalition 2's, strangers by the global θ — and
training keeps publishing new rounds that must go live without a serving
hiccup.

Design (the reference's, ``repro.serve.frontend``, on PyTorch):

* **One stacked model dict.**  All M = K + 1 served models (row 0 = θ,
  row 1 + k = coalition k, the :mod:`repro_torch.serve.routing`
  convention) live as one dict of tensors with a leading model axis, built
  from a snapshot by :func:`repro_torch.core.pytree.matrix_to_stacked`, the
  inverse of the engine's flattening.
* **One program per input signature.**  The forward runs every model row
  over the whole batch and gathers ``outs[row[q], q]`` per query: no
  per-query weight gathers and no data-dependent shapes.  On a CUDA card
  the program is a CUDA graph, captured once per (batch shape, dtype) and
  replayed; on the CPU it runs eagerly, and the program "built" for a
  signature is its first run.
* **Hot swap = same tensors, new values.**  :meth:`swap` writes the new
  round into the installed tensors with ``copy_`` (it lays the snapshot
  out in temporaries first; the served tensors are never reallocated), so
  the captured graphs, which read those tensors, serve the new weights.
  :attr:`compile_count` counts graph captures on the card and signatures
  on the CPU; "swaps never rebuild" is testable as it staying flat across
  :meth:`swap`.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import pytree
from repro_torch.serve.routing import GLOBAL, RoutingTable
from repro_torch.serve.store import ModelStore, Snapshot

Params = dict[str, torch.Tensor]


class BatchServer:
    """Serve batched queries through the routed models of one snapshot.

    Args:
      apply_fn: ``(params, x) -> outputs`` forward pass of the served model
        family (per-model stateless; the port's ``cnn.apply`` qualifies).
      layout: the model's layout (:mod:`repro_torch.core.pytree`): how the
        snapshot's reference-named θ and its flat barycenters map onto the
        parameters ``apply_fn`` takes.
      snapshot: optional initial :class:`Snapshot` to install.
      device: where the models live and the forward runs (default: the
        snapshot's barycenters' device).
    """

    def __init__(self, apply_fn: Callable[[Params, torch.Tensor],
                                          torch.Tensor],
                 layout, snapshot: Snapshot | None = None, *, device=None):
        self.apply_fn = apply_fn
        self.layout = layout
        self.device = None if device is None else torch.device(device)
        self._stacked: Params | None = None
        self._table: RoutingTable | None = None
        self._round: int | None = None
        #: signature -> (graph, static x, static rows, static out) on the
        #: card, or None on the CPU
        self._programs: dict[tuple, tuple | None] = {}
        self._compiles = 0
        # host-side serve counters (``stats``); nothing here is seen by
        # the forward, so reading them never rebuilds it
        self._counters = {"polls": 0, "poll_hits": 0, "swaps": 0,
                          "swap_ms_total": 0.0, "batches": 0, "queries": 0,
                          "fallback_queries": 0}
        if snapshot is not None:
            self.install(snapshot)

    # -- weight management ----------------------------------------------------

    def _build(self, snap: Snapshot) -> tuple[Params, RoutingTable]:
        """The snapshot's (M, ...) stacked models and its routing table."""
        device = self.device or snap.barycenters.device
        params = pytree.from_ref_tree(snap.global_params, self.layout, device)
        theta = pytree.flatten(params, self.layout)
        bary = torch.as_tensor(snap.barycenters).to(device=device,
                                                    dtype=theta.dtype)
        if bary.ndim != 2 or bary.shape[1] != theta.shape[0]:
            raise ValueError(
                f"barycenters {tuple(bary.shape)} do not match the global "
                f"model's D={theta.shape[0]}")
        mat = torch.cat([theta[None, :], bary], dim=0)          # (M, D)
        stacked = pytree.matrix_to_stacked(mat, self.layout, params)
        return stacked, RoutingTable.from_snapshot(snap)

    def _same_avals(self, stacked: Params, table: RoutingTable) -> bool:
        old = self._stacked
        return (old is not None and old.keys() == stacked.keys()
                and all(old[k].shape == stacked[k].shape
                        and old[k].dtype == stacked[k].dtype
                        and old[k].device == stacked[k].device
                        for k in old)
                and self._table.n_clients == table.n_clients)

    @torch.no_grad()
    def install(self, snap: Snapshot) -> None:
        """(Re)build the stacked models + routing table from a snapshot.

        A snapshot of the installed shapes is written into the installed
        tensors (as :meth:`swap`); any other replaces them and drops the
        programs built on the old ones.
        """
        stacked, table = self._build(snap)
        if self._same_avals(stacked, table):
            for k, t in self._stacked.items():
                t.copy_(stacked[k])
        else:
            self._stacked = stacked
            self._programs.clear()
        self._table = table
        self._round = snap.round

    @torch.no_grad()
    def swap(self, snap: Snapshot) -> None:
        """Hot-swap to a newer snapshot, in place; never rebuilds.

        The incoming snapshot's models (leaf shapes and dtypes, coalition
        count, client population) must match what is installed; a
        different model family is a new :class:`BatchServer`.
        """
        if self._stacked is None:
            raise RuntimeError("nothing installed yet; use install()")
        stacked, table = self._build(snap)
        if not self._same_avals(stacked, table):
            raise ValueError(
                "snapshot is not hot-swappable: model shapes/dtypes or "
                "population changed (install() a fresh server instead)")
        for k, t in self._stacked.items():
            t.copy_(stacked[k])
        self._table = table
        self._round = snap.round

    def poll(self, store: ModelStore) -> bool:
        """Swap in the store's newest round if it is newer than ours.

        Returns True if a swap happened.  ``swap_ms`` times the install or
        swap, ended by a device synchronise on the card.
        """
        self._counters["polls"] += 1
        latest = store.latest_round()
        if latest is None or latest == self._round:
            return False
        snap = store.load(latest, device=self.device)
        t0 = time.perf_counter()
        if self._stacked is None:
            self.install(snap)
        else:
            self.swap(snap)
        if self._stacked_device().type == "cuda":
            torch.cuda.synchronize(self._stacked_device())
        self._counters["poll_hits"] += 1
        self._counters["swaps"] += 1
        self._counters["swap_ms_total"] += (time.perf_counter() - t0) * 1e3
        return True

    def _stacked_device(self) -> torch.device:
        return next(iter(self._stacked.values())).device

    # -- inference ------------------------------------------------------------

    def _forward(self, rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        n_models = next(iter(self._stacked.values())).shape[0]
        outs = torch.stack([
            self.apply_fn({k: v[m] for k, v in self._stacked.items()}, x)
            for m in range(n_models)])                       # (M, B, ...)
        return outs[rows, torch.arange(x.shape[0], device=x.device)]

    def _program(self, rows: torch.Tensor, x: torch.Tensor):
        """The signature's captured graph (card) or None (CPU), built on its
        first call; ``compile_count`` counts the builds."""
        sig = (tuple(x.shape), x.dtype, x.device)
        if sig in self._programs:
            return self._programs[sig]
        self._compiles += 1
        prog = None
        if x.device.type == "cuda":
            static_x, static_rows = x.clone(), rows.clone()
            side = torch.cuda.Stream(x.device)
            side.wait_stream(torch.cuda.current_stream(x.device))
            with torch.cuda.stream(side):
                for _ in range(2):             # warm up outside the capture
                    self._forward(static_rows, static_x)
            torch.cuda.current_stream(x.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static_out = self._forward(static_rows, static_x)
            prog = (graph, static_x, static_rows, static_out)
        self._programs[sig] = prog
        return prog

    @torch.no_grad()
    def serve(self, client_ids, x: torch.Tensor) -> torch.Tensor:
        """Answer a batch: query q runs through client_ids[q]'s routed
        model."""
        if self._stacked is None:
            raise RuntimeError("no snapshot installed; publish + install "
                               "(or poll a ModelStore) first")
        ids = np.asarray(client_ids).reshape(-1)
        if ids.shape[0] != x.shape[0]:
            raise ValueError(
                f"{ids.shape[0]} client ids for a batch of {x.shape[0]}")
        self._counters["batches"] += 1
        self._counters["queries"] += int(ids.shape[0])
        self._counters["fallback_queries"] += int(
            np.sum(self._table.route(ids) == GLOBAL))
        x = x.to(self._stacked_device())
        rows = torch.as_tensor(self._table.model_rows(ids), dtype=torch.long,
                               device=x.device)
        prog = self._program(rows, x)
        if prog is None:
            return self._forward(rows, x)
        graph, static_x, static_rows, static_out = prog
        static_x.copy_(x)
        static_rows.copy_(rows)
        graph.replay()
        return static_out.clone()

    # -- introspection --------------------------------------------------------

    def model_params(self, row: int) -> Params:
        """One served model's parameters (row 0 = θ, 1 + k = coalition k)."""
        if self._stacked is None:
            raise RuntimeError("no snapshot installed")
        return {k: v[row] for k, v in self._stacked.items()}

    @property
    def round(self) -> int | None:
        """Round of the currently served snapshot."""
        return self._round

    @property
    def routing(self) -> RoutingTable | None:
        return self._table

    @property
    def compile_count(self) -> int:
        """Programs built: graph captures on the card, signatures on the
        CPU (flat across swaps)."""
        return self._compiles

    @property
    def stats(self) -> dict:
        """Host-side serve counters (cumulative since construction):
        ``polls``/``poll_hits``, ``swaps`` + ``swap_ms_total``,
        ``batches``/``queries``, ``fallback_queries`` (routed to θ because
        the client was unknown) and ``compiles``; the ``serve_batch``
        record of the :mod:`repro_torch.obs` ledger."""
        return dict(self._counters, compiles=self._compiles)
