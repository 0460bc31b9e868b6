"""Pluggable aggregation strategies — the federation engine's extension point.

Every aggregation rule is a :class:`Strategy` with one contract:

  ``init_state(w0, ...) -> state``      — the rule's own state from the
                                          round-0 client weights
  ``round(w, state) -> RoundResult``    — consume the (N, D) client weight
                                          matrix, emit θ, the next state and
                                          metrics

The reference's participation ``mask`` argument serves its substrate
engines and waits for them (ROADMAP queue A item 8); the client weights it
folds into reach :func:`repro_torch.core.coalitions.run_round` directly.

Strategies are built through a registry::

    @register_strategy("my_rule")
    def _make(*, n_clients, n_coalitions, backend, **extra) -> Strategy: ...

    strat = make_strategy("my_rule", n_clients=10, n_coalitions=3)

Ported so far: ``coalition``, the paper's Algorithm 1 (θ = mean of the
coalition barycenters), and ``coalition_topk`` (θ = mean of the ``top_m``
most populated coalitions' barycenters); both take a sketch.  ``fedavg``,
``fedavg_weighted`` and ``fedavg_trimmed`` wait for ROADMAP queue A item 5.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import backends as bk
from repro_torch.core import coalitions as co
from repro_torch.core import sketch as sk_mod


class RoundMetrics(NamedTuple):
    """Per-round observables every strategy reports."""

    assignment: torch.Tensor   # (N,) int64 group id per client
    counts: torch.Tensor       # (n_groups,) float32 group sizes / masses
    radius: torch.Tensor        # (n_groups,) float32 intra radius


class RoundResult(NamedTuple):
    """What one strategy round produces."""

    theta: torch.Tensor        # (D,) float32 — the new global model
    state: Any                 # strategy state for the next round
    metrics: RoundMetrics
    barycenters: torch.Tensor  # (n_groups, D) per-group models


@dataclasses.dataclass(frozen=True)
class Strategy(abc.ABC):
    """Base class for aggregation strategies.

    ``n_groups`` is the length of ``metrics.counts`` (= ``n_coalitions`` for
    coalition rules).
    """

    n_clients: int
    n_groups: int = 1

    @abc.abstractmethod
    def init_state(self, w0: torch.Tensor, *, perm: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> Any:
        """State from the round-0 client weight matrix ``w0``; ``perm`` and
        ``generator`` serve rules that draw randomness (injected draw, or the
        generator to draw from)."""

    @abc.abstractmethod
    def round(self, w: torch.Tensor, state: Any) -> RoundResult:
        """One aggregation round over client weights ``w``."""


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

    def init_state(self, w0, *, perm=None, generator=None):
        return co.init_centers(w0, self.n_groups, perm=perm,
                               generator=generator)

    def _coalition_round(self, w, state) -> co.CoalitionRound:
        return co.run_round(w, state, backend=self.backend,
                            sketcher=self.sketcher)

    def _result(self, r: co.CoalitionRound, theta) -> RoundResult:
        return RoundResult(theta=theta, state=r.state,
                           metrics=RoundMetrics(assignment=r.assignment,
                                                counts=r.counts,
                                                radius=r.radius),
                           barycenters=r.barycenters)

    def round(self, w, state):
        r = self._coalition_round(w, state)
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

    def round(self, w, state):
        r = self._coalition_round(w, state)
        order = torch.sort(r.counts, descending=True, stable=True).indices
        theta = torch.mean(r.barycenters[order[:self.top_m]], dim=0)
        return self._result(r, theta)


def _resolve_sketcher(sketch=None, sketch_dim=None) -> sk_mod.Sketcher | None:
    """Factory plumbing for the ``--sketch``/``--sketch-dim`` CLI knobs: a
    registered name (sketch seed 0, as the reference's CLI) or a Sketcher."""
    if sketch is None or isinstance(sketch, sk_mod.Sketcher):
        return sketch
    return sk_mod.make_sketcher(sketch, dim=sketch_dim)


@register_strategy("coalition")
def _make_coalition(*, n_clients, n_coalitions=3, backend="stream",
                    sketch=None, sketch_dim=None, **_) -> Strategy:
    return CoalitionStrategy(n_clients=n_clients, n_groups=n_coalitions,
                             backend=bk.get_backend(backend),
                             sketcher=_resolve_sketcher(sketch, sketch_dim))


@register_strategy("coalition_topk")
def _make_coalition_topk(*, n_clients, n_coalitions=3, backend="stream",
                         top_m=None, sketch=None, sketch_dim=None,
                         **_) -> Strategy:
    if top_m is None:
        top_m = max(1, n_coalitions - 1)
    return TopKCoalitionStrategy(n_clients=n_clients, n_groups=n_coalitions,
                                 backend=bk.get_backend(backend),
                                 sketcher=_resolve_sketcher(sketch, sketch_dim),
                                 top_m=top_m)
