"""Pluggable aggregation strategies — the federation engine's extension point.

Every aggregation rule is a :class:`Strategy` with one contract:

  ``init_state(w0, ...) -> state``      — the rule's own state from the
                                          round-0 client weights
  ``round(w, state, mask=None)``        — consume the (N, D) client weight
            ``-> RoundResult``            matrix, emit θ, the next state and
                                          metrics

``mask`` is the IoT substrate's participation contract (the ``semi_async``
engine of :mod:`repro_torch.core.server`): an optional (N,) tensor of
per-client participation/staleness weights in [0, 1] — 1 for a client that
delivered this round, ``(1 + tau)^-alpha`` for a buffered update ``tau``
rounds old, 0 for a client that is excluded.  ``mask=None`` is the
synchronous path; an all-ones mask is bit-identical to it (rules weight by
multiplying with the mask, and multiplying by exactly 1.0 is an identity),
which is what lets ``semi_async`` reproduce ``scan`` on the ideal fleet.

Strategies are built through a registry::

    @register_strategy("my_rule")
    def _make(*, n_clients, n_coalitions, backend, **extra) -> Strategy: ...

    strat = make_strategy("my_rule", n_clients=10, n_coalitions=3)

Built-ins:

  ``fedavg``            — uniform client mean (the paper's baseline)
  ``fedavg_weighted``   — client-weighted FedAvg (n_k/n weighting)
  ``fedavg_trimmed``    — coordinate-wise trimmed mean over present rows
  ``coalition``         — the paper's Algorithm 1 (θ = mean of coalition
                          barycenters)
  ``coalition_topk``    — θ = mean of the ``top_m`` most populated
                          coalitions' barycenters

The two coalition rules take a sketch and client weights.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, ClassVar, NamedTuple

import torch

from repro_torch.core import aggregation
from repro_torch.core import backends as bk
from repro_torch.core import coalitions as co
from repro_torch.core import sketch as sk_mod


class RoundMetrics(NamedTuple):
    """Per-round observables every strategy reports (flat rules put every
    client in group 0)."""

    assignment: torch.Tensor   # (N,) int64 group id per client
    counts: torch.Tensor       # (n_groups,) float32 group sizes / masses
    #: (n_groups,) float32 intra radius; None lets the engine report zeros
    radius: torch.Tensor | None = None
    #: (N, n_groups) float32 client->barycenter squared distances the
    #: coalition round already has for the medoid election (the attack
    #: path's contamination bound reads it); None for flat rules
    med_d2: torch.Tensor | None = None


class RoundResult(NamedTuple):
    """What one strategy round produces.  ``barycenters`` is None for flat
    rules: the engine then serves θ to every group."""

    theta: torch.Tensor        # (D,) float32 — the new global model
    state: Any                 # strategy state for the next round
    metrics: RoundMetrics
    barycenters: torch.Tensor | None = None   # (n_groups, D) per-group models


@dataclasses.dataclass(frozen=True)
class Strategy(abc.ABC):
    """Base class for aggregation strategies.

    ``n_groups`` is the length of ``metrics.counts`` (= ``n_coalitions`` for
    coalition rules).
    """

    n_clients: int
    n_groups: int = 1

    #: coalition rules set True: only ``n_groups`` barycenter-sized models
    #: cross the WAN per round (members reach their heads over the edge
    #: link); the ``semi_async`` engine's byte accounting keys off this
    hierarchical: ClassVar[bool] = False

    @abc.abstractmethod
    def init_state(self, w0: torch.Tensor, *, perm: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> Any:
        """State from the round-0 client weight matrix ``w0``; ``perm`` and
        ``generator`` serve rules that draw randomness (injected draw, or the
        generator to draw from)."""

    @abc.abstractmethod
    def round(self, w: torch.Tensor, state: Any,
              mask: torch.Tensor | None = None) -> RoundResult:
        """One aggregation round over client weights ``w``; ``mask`` the
        optional (N,) participation/staleness weights (None = every client
        fresh and present)."""

    def _flat_metrics(self, w: torch.Tensor,
                      mask: torch.Tensor | None = None) -> RoundMetrics:
        """Everyone in group 0; with a mask, group 0 reports the
        participating mass Σ_i m_i (the head-count when it is binary)."""
        counts = torch.zeros((self.n_groups,), dtype=torch.float32,
                             device=w.device)
        if mask is None:
            counts[0] = float(self.n_clients)
        else:
            counts[0] = torch.sum(mask.float())
        return RoundMetrics(
            assignment=torch.zeros((self.n_clients,), dtype=torch.long,
                                   device=w.device),
            counts=counts,
            radius=torch.zeros((self.n_groups,), dtype=torch.float32,
                               device=w.device))


# --- registry --------------------------------------------------------------------

_STRATEGIES: dict[str, Callable[..., Strategy]] = {}


def register_strategy(name: str) -> Callable:
    """Decorator: register a strategy factory under ``name``.

    The factory receives keyword config: ``n_clients``, ``n_coalitions``,
    ``backend`` and the rule's own keywords (it ignores those of others).
    """

    def deco(factory: Callable[..., Strategy]) -> Callable[..., Strategy]:
        _STRATEGIES[name] = factory
        return factory

    return deco


def make_strategy(name: str, *, n_clients: int, n_coalitions: int = 1,
                  backend: str | bk.Backend = "stream", **extra) -> Strategy:
    """Build a registered strategy from shared + rule-specific config."""
    try:
        factory = _STRATEGIES[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; available: {available_strategies()}"
        ) from None
    return factory(n_clients=n_clients, n_coalitions=n_coalitions,
                   backend=backend, **extra)


def available_strategies() -> tuple[str, ...]:
    return tuple(sorted(_STRATEGIES))


def _on(t: torch.Tensor | None, w: torch.Tensor) -> torch.Tensor | None:
    """``t`` on ``w``'s device (a no-op when it is there already)."""
    return None if t is None else t.to(w.device)


# --- flat (non-partitioning) rules ----------------------------------------------

@dataclasses.dataclass(frozen=True)
class FedAvgStrategy(Strategy):
    """FedAvg: (optionally weighted) mean of client weights.

    ``client_weights=None`` is the paper's baseline (equal shards ⇒ uniform
    mean); pass shard sizes for the classical n_k/n weighting.
    """

    client_weights: torch.Tensor | None = None

    def init_state(self, w0, *, perm=None, generator=None):
        return 0                                 # just a round counter

    def round(self, w, state, mask=None):
        cw = _on(self.client_weights, w)
        if mask is None:
            theta = aggregation.fedavg(w, cw)
        else:
            theta = aggregation.fedavg_masked(w, mask, cw)
        return RoundResult(theta=theta, state=state + 1,
                           metrics=self._flat_metrics(w, mask))


@dataclasses.dataclass(frozen=True)
class TrimmedFedAvgStrategy(Strategy):
    """Coordinate-wise trimmed mean: drop the ``trim`` largest and smallest
    client values per parameter before averaging (robust-aggregation
    family)."""

    trim: int = 1

    def __post_init__(self):
        if not 0 <= 2 * self.trim < self.n_clients:
            raise ValueError(
                f"trim={self.trim} must satisfy 0 <= 2*trim < "
                f"n_clients={self.n_clients}")

    def init_state(self, w0, *, perm=None, generator=None):
        return 0

    def round(self, w, state, mask=None):
        # the trim budget is a contract over delivered rows, so the order
        # statistics run over the present ones; mask=None is all present
        if mask is None:
            mask = torch.ones((self.n_clients,), dtype=torch.float32,
                              device=w.device)
        theta = aggregation.trimmed_mean_masked(w, self.trim, mask)
        return RoundResult(theta=theta, state=state + 1,
                           metrics=self._flat_metrics(w, mask))


# --- coalition rules (Algorithm 1) -----------------------------------------------

@dataclasses.dataclass(frozen=True)
class CoalitionStrategy(Strategy):
    """The paper's Algorithm 1: weight-distance coalitions, θ = mean of
    coalition barycenters.  State is the center-index recurrence v_j^r."""

    backend: bk.Backend = dataclasses.field(
        default_factory=lambda: bk.get_backend("stream"))
    #: optional sketched geometry: a non-identity sketcher runs assignment
    #: and medoid election on the (N, S) sketch; None/identity is exact
    sketcher: sk_mod.Sketcher | None = None
    #: optional (N,) barycenter client weights (uniform if None)
    client_weights: torch.Tensor | None = None
    #: column tile of the streaming sweeps; None = the size-derived default
    #: (:func:`repro_torch.core.fused.resolve_chunk`)
    chunk: int | None = None

    hierarchical: ClassVar[bool] = True

    def init_state(self, w0, *, perm=None, generator=None):
        return co.init_centers(w0, self.n_groups, perm=perm,
                               generator=generator)

    def _coalition_round(self, w, state, mask=None) -> co.CoalitionRound:
        # The mask folds into the barycenter client weights: present
        # clients at full mass, buffered updates at their decayed mass,
        # excluded clients at 0.  Formation still places every row, but
        # barycenters (and θ) aggregate the weighted cohort only, and a
        # zero-mass client cannot be elected medoid.
        cw = _on(self.client_weights, w)
        if mask is not None:
            cw = mask if cw is None else cw * mask
        return co.run_round(w, state, backend=self.backend,
                            client_weights=cw, chunk=self.chunk,
                            sketcher=self.sketcher)

    def _result(self, r: co.CoalitionRound, theta) -> RoundResult:
        return RoundResult(theta=theta, state=r.state,
                           metrics=RoundMetrics(assignment=r.assignment,
                                                counts=r.counts,
                                                radius=r.radius,
                                                med_d2=r.med_d2),
                           barycenters=r.barycenters)

    def round(self, w, state, mask=None):
        r = self._coalition_round(w, state, mask)
        return self._result(r, r.theta)


@dataclasses.dataclass(frozen=True)
class TopKCoalitionStrategy(CoalitionStrategy):
    """Trimmed Algorithm 1: θ averages only the ``top_m`` most populated
    coalitions, so splinter groups stop pulling the global model.  Equal
    counts go to the lower coalition index (a stable descending sort), as
    ``jax.lax.top_k`` breaks them in the reference."""

    top_m: int = 1

    def __post_init__(self):
        if not 1 <= self.top_m <= self.n_groups:
            raise ValueError(
                f"top_m={self.top_m} must be in [1, n_coalitions="
                f"{self.n_groups}]")

    def round(self, w, state, mask=None):
        r = self._coalition_round(w, state, mask)
        order = torch.sort(r.counts, descending=True, stable=True).indices
        theta = torch.mean(r.barycenters[order[:self.top_m]], dim=0)
        return self._result(r, theta)


# --- built-in factories ----------------------------------------------------------

@register_strategy("fedavg")
def _make_fedavg(*, n_clients, n_coalitions=1, backend="stream",
                 **_) -> Strategy:
    return FedAvgStrategy(n_clients=n_clients, n_groups=n_coalitions)


@register_strategy("fedavg_weighted")
def _make_fedavg_weighted(*, n_clients, n_coalitions=1, backend="stream",
                          client_weights=None, **_) -> Strategy:
    if client_weights is None:
        client_weights = torch.ones((n_clients,), dtype=torch.float32)
    return FedAvgStrategy(n_clients=n_clients, n_groups=n_coalitions,
                          client_weights=torch.as_tensor(client_weights))


@register_strategy("fedavg_trimmed")
def _make_fedavg_trimmed(*, n_clients, n_coalitions=1, backend="stream",
                         trim=1, **_) -> Strategy:
    return TrimmedFedAvgStrategy(n_clients=n_clients, n_groups=n_coalitions,
                                 trim=trim)


def _resolve_sketcher(sketch=None, sketch_dim=None) -> sk_mod.Sketcher | None:
    """Factory plumbing for the ``--sketch``/``--sketch-dim`` CLI knobs: a
    registered name (sketch seed 0, as the reference's CLI) or a Sketcher."""
    if sketch is None or isinstance(sketch, sk_mod.Sketcher):
        return sketch
    return sk_mod.make_sketcher(sketch, dim=sketch_dim)


@register_strategy("coalition")
def _make_coalition(*, n_clients, n_coalitions=3, backend="stream",
                    client_weights=None, chunk=None, sketch=None,
                    sketch_dim=None, **_) -> Strategy:
    return CoalitionStrategy(n_clients=n_clients, n_groups=n_coalitions,
                             backend=bk.get_backend(backend),
                             sketcher=_resolve_sketcher(sketch, sketch_dim),
                             client_weights=client_weights, chunk=chunk)


@register_strategy("coalition_topk")
def _make_coalition_topk(*, n_clients, n_coalitions=3, backend="stream",
                         client_weights=None, top_m=None, chunk=None,
                         sketch=None, sketch_dim=None, **_) -> Strategy:
    if top_m is None:
        top_m = max(1, n_coalitions - 1)
    return TopKCoalitionStrategy(n_clients=n_clients, n_groups=n_coalitions,
                                 backend=bk.get_backend(backend),
                                 sketcher=_resolve_sketcher(sketch, sketch_dim),
                                 client_weights=client_weights, top_m=top_m,
                                 chunk=chunk)
