"""Strategy-driven federation engine.

The paper's outer loop (Algorithm 1) is one
:mod:`repro_torch.core.strategies` entry; this module is the *engine* that
drives a registered strategy:

  broadcast θ -> vmapped ClientUpdate over all clients -> (N, D) weight
  matrix -> ``strategy.round(w, state)`` -> new θ + next state + metrics

Round 0 is the census: every client trains from θ^(0), the strategy state is
initialised from those weights (Step I for coalition rules), and the first
aggregation runs on them.  Rounds 1 .. R-1 follow.  So a run of R rounds
makes R server steps.

The reference's ``scan`` engine compiles the rounds into one ``lax.scan``
program and its ``python`` engine loops on the host; PyTorch runs eagerly,
so here both names run the same Python round loop.  Dense mode only: the
``semi_async``/``event_driven`` engines and cohort/mesh modes wait for
ROADMAP queue A items 8 and 10.

Randomness: each round draws every client's per-epoch shuffles, and round 0
draws the Step-I permutation, from one ``torch.Generator`` in that order.
:class:`Draws` injects them instead (the parity tests pass the reference's
threefry draws).

Per round the engine records the loss/accuracy, the coalition structure,
the dynamics block (churn, size entropy, intra radius, barycenter drift)
and the seconds spent in the local phase and in the server step (each ended
by a device synchronise).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import backends as bk
from repro_torch.core import pytree, strategies
from repro_torch.core.client import ClientConfig, local_phase, validate_dp
from repro_torch.core.strategies import Strategy
from repro_torch.models.zoo import FLModel
from repro_torch.obs import metrics as obs_metrics


class FederationConfig(NamedTuple):
    n_clients: int = 10
    n_coalitions: int = 3
    rounds: int = 30
    method: str = "coalition"          # any registered strategy name
    client: ClientConfig = ClientConfig()
    backend: str = "stream"            # distance/barycenter backend name
    engine: str = "scan"               # 'scan' | 'python'


class Draws(NamedTuple):
    """Injected randomness for a run.

    ``shuffles[r]`` is round r's (N, E, n) per-client, per-epoch sample
    order; ``center_perm`` the (N,) Step-I permutation of round 0.
    """

    shuffles: Sequence[Any]
    center_perm: Any


class Trace(NamedTuple):
    """Stacked per-round numpy arrays for R rounds."""

    loss: np.ndarray        # (R,)   mean final-epoch training loss
    acc: np.ndarray         # (R,)   test accuracy of θ^(r)
    assignment: np.ndarray  # (R, N) per-client group id
    counts: np.ndarray      # (R, K) group sizes / masses
    churn: np.ndarray       # (R,)   fraction of clients whose group flipped
    entropy: np.ndarray     # (R,)   size-histogram Shannon entropy (nats)
    radius: np.ndarray      # (R, K) RMS member->barycenter distance
    drift: np.ndarray       # (R, K) ‖b_k(r) − b_k(r−1)‖
    local_s: np.ndarray     # (R,)   seconds in the local phase
    server_s: np.ndarray    # (R,)   seconds in the server step


@dataclasses.dataclass
class History:
    """Federation history as stacked arrays, with the reference's list view."""

    trace: Trace

    @property
    def rounds(self) -> list[int]:
        return list(range(int(self.trace.loss.shape[0])))

    @property
    def train_loss(self) -> list[float]:
        return [float(x) for x in self.trace.loss]

    @property
    def test_acc(self) -> list[float]:
        return [float(x) for x in self.trace.acc]

    @property
    def assignments(self) -> list[list[int]]:
        return self.trace.assignment.astype(int).tolist()

    @property
    def counts(self) -> list[list[int]]:
        return self.trace.counts.astype(int).tolist()

    @property
    def churn(self) -> list[float]:
        return [float(x) for x in self.trace.churn]

    @property
    def entropy(self) -> list[float]:
        return [float(x) for x in self.trace.entropy]

    @property
    def drift(self) -> list[list[float]]:
        return self.trace.drift.astype(float).tolist()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Federation:
    """A federation = one strategy + the round loop over a client population.

    Args:
      model: the :class:`~repro_torch.models.zoo.FLModel` clients train.
      eval_fn: params -> scalar test accuracy.
      cfg: federation configuration; ``cfg.method`` names a registered
        strategy unless ``strategy`` is given.  Engine and backend are
        validated here.
      strategy: optional pre-built :class:`Strategy` (overrides cfg.method).
    """

    _ENGINES = ("python", "scan")

    def __init__(self, model: FLModel, eval_fn: Callable[[dict], torch.Tensor],
                 cfg: FederationConfig, strategy: Strategy | None = None):
        if cfg.engine not in self._ENGINES:
            raise ValueError(
                f"engine {cfg.engine!r} is not ported; ported engines: "
                f"{self._ENGINES} (semi_async and event_driven wait for "
                "ROADMAP queue A item 8)")
        try:
            bk.get_backend(cfg.backend)
        except KeyError:
            raise ValueError(
                f"unknown backend {cfg.backend!r}; registered backends: "
                f"{bk.available_backends()}") from None
        validate_dp(cfg.client)
        self.model = model
        self.eval_fn = eval_fn
        self.cfg = cfg
        self.strategy = strategy if strategy is not None else \
            strategies.make_strategy(cfg.method, n_clients=cfg.n_clients,
                                     n_coalitions=cfg.n_coalitions,
                                     backend=cfg.backend)

    def _shuffles(self, r: int, n: int, device, generator, draws) -> torch.Tensor:
        if draws is not None:
            return torch.as_tensor(np.asarray(draws.shuffles[r]),
                                   dtype=torch.long, device=device)
        u = torch.rand((self.cfg.n_clients, self.cfg.client.epochs, n),
                       generator=generator)
        return torch.argsort(u, dim=-1).to(device)

    def run(self, init_params: dict[str, torch.Tensor],
            client_data: dict[str, torch.Tensor], *,
            generator: torch.Generator | None = None,
            draws: Draws | None = None) -> tuple[dict, History]:
        """Run the full federation; returns (final θ params, History).

        Args:
          init_params: θ^(0), on the device the run uses.
          client_data: dict of (n_clients, n_local, ...) tensors on that
            device.
          generator: CPU ``torch.Generator`` the shuffles and the Step-I
            permutation are drawn from (ignored with ``draws``).
          draws: injected randomness (:class:`Draws`).
        """
        if generator is None and draws is None:
            raise ValueError("run needs a generator or injected draws")
        layout = self.model.layout
        device = next(iter(client_data.values())).device
        n_local = next(iter(client_data.values())).shape[1]
        rows = []
        gp, state, prev_assign, prev_bary = init_params, None, None, None
        for r in range(self.cfg.rounds):
            t0 = time.perf_counter()
            perms = self._shuffles(r, n_local, device, generator, draws)
            stacked, losses = local_phase(self.model.loss_fn, gp, client_data,
                                          perms, self.cfg.client)
            w = pytree.client_matrix(stacked, layout)
            _sync(device)
            t1 = time.perf_counter()
            if r == 0:
                state = self.strategy.init_state(
                    w, perm=None if draws is None else draws.center_perm,
                    generator=generator)
            res = self.strategy.round(w, state)
            _sync(device)
            t2 = time.perf_counter()
            state = res.state
            gp = pytree.unflatten(res.theta, layout, gp)
            bary = res.barycenters
            assignment = res.metrics.assignment
            row = {"loss": torch.mean(losses), "acc": self.eval_fn(gp),
                   "assignment": assignment, "counts": res.metrics.counts,
                   "entropy": obs_metrics.size_entropy(res.metrics.counts),
                   "radius": res.metrics.radius,
                   "local_s": t1 - t0, "server_s": t2 - t1}
            if r == 0:       # the census has no previous round to compare to
                row["churn"] = 0.0
                row["drift"] = torch.zeros(self.strategy.n_groups)
            else:
                row["churn"] = obs_metrics.membership_churn(assignment,
                                                            prev_assign)
                row["drift"] = obs_metrics.barycenter_drift(bary, prev_bary)
            rows.append({k: v.detach().cpu().numpy() if torch.is_tensor(v)
                         else np.asarray(v) for k, v in row.items()})
            prev_assign, prev_bary = assignment, bary
        trace = Trace(**{f: np.stack([row[f] for row in rows])
                         for f in Trace._fields})
        return gp, History(trace=trace)
