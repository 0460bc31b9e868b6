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

Three engines run that round program:

  ``'scan'`` / ``'python'`` — the reference compiles the rounds into one
                 ``lax.scan`` program (``scan``) or loops on the host
                 (``python``); PyTorch runs eagerly, so here both names
                 run the same Python round loop.
  ``'semi_async'`` — the IoT-substrate engine (:mod:`repro_torch.sim`):
                 the same loop over a simulated device fleet with partial
                 participation and staleness-weighted merging.  Each round
                 an availability process and a deadline give the
                 participation mask; present clients deliver fresh updates,
                 absent ones keep their last delivered update in a buffer
                 with a growing staleness counter ``tau``, and the strategy
                 aggregates the buffer under the weights ``(1 + tau)^-alpha``
                 (the ``mask`` of ``Strategy.round``).  Simulated seconds
                 and bytes on the WAN and edge links land in the
                 :class:`Trace`.  On the ``ideal`` fleet every substrate
                 step is an exact no-op and the engine equals ``scan`` bit
                 for bit.

Dense mode only: the ``event_driven`` engine, cohort mode and mesh mode
wait for ROADMAP queue A.3b and A.6.

Randomness: each round draws every client's per-epoch shuffles, and round 0
draws the Step-I permutation, from one ``torch.Generator`` in that order.
``semi_async`` draws its availability in bulk, before round 0, from a
generator of its own (seeded from the run generator's seed offset by
``sim.AVAILABILITY_STREAM``), so the client draws are those of ``scan``.
:class:`Draws` injects them all instead (the parity tests pass the
reference's threefry draws).

Per round the engine records the loss/accuracy, the coalition structure,
the dynamics block (churn, size entropy, intra radius, barycenter drift)
and the seconds spent in the local phase and in the server step (each ended
by a device synchronise; the server step is the strategy's round alone).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import sim as sim_mod
from repro_torch.core import backends as bk
from repro_torch.core import pytree, strategies
from repro_torch.core.client import ClientConfig, local_phase, validate_dp
from repro_torch.core.strategies import RoundMetrics, RoundResult, Strategy
from repro_torch.models.zoo import FLModel
from repro_torch.obs import metrics as obs_metrics


def bytes_per_param(w: torch.Tensor) -> int:
    """On-wire bytes per parameter of a single-dtype tensor (a bf16 model
    moves half the bytes of an f32 one).  The engine bills whole models by
    :func:`pytree.tree_bytes`, leaf by leaf."""
    return w.element_size()


class FederationConfig(NamedTuple):
    n_clients: int = 10
    n_coalitions: int = 3
    rounds: int = 30
    method: str = "coalition"          # any registered strategy name
    client: ClientConfig = ClientConfig()
    backend: str = "stream"            # distance/barycenter backend name
    engine: str = "scan"               # 'scan' | 'python' | 'semi_async'
    sim: sim_mod.SimConfig = sim_mod.SimConfig()   # IoT substrate knobs


class Draws(NamedTuple):
    """Injected randomness for a run.

    ``shuffles[r]`` is round r's (N, E, n) per-client, per-epoch sample
    order; ``center_perm`` the (N,) Step-I permutation of round 0;
    ``availability`` the ``semi_async`` engine's census and per-round
    availability booleans (None: drawn as without injected draws).
    """

    shuffles: Sequence[Any]
    center_perm: Any
    availability: sim_mod.AvailabilityDraws | None = None


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
    # --- semi_async only (None on scan / python) -----------------------------
    sim_time: np.ndarray | None = None       # (R,) simulated seconds a round
    wan_bytes: np.ndarray | None = None      # (R,) bytes over the WAN link
    edge_bytes: np.ndarray | None = None     # (R,) bytes over edge links
    participation: np.ndarray | None = None  # (R, N) 0/1 participation mask


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

    @staticmethod
    def _float_list(arr) -> list[float] | None:
        return None if arr is None else [float(x) for x in arr]

    @property
    def sim_times(self) -> list[float] | None:
        """Per-round simulated seconds (semi_async only)."""
        return self._float_list(self.trace.sim_time)

    @property
    def wan_bytes(self) -> list[float] | None:
        return self._float_list(self.trace.wan_bytes)

    @property
    def edge_bytes(self) -> list[float] | None:
        return self._float_list(self.trace.edge_bytes)

    @property
    def participation(self) -> list[list[int]] | None:
        if self.trace.participation is None:
            return None
        return self.trace.participation.astype(int).tolist()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Federation:
    """A federation = one strategy + one engine over a client population.

    Args:
      model: the :class:`~repro_torch.models.zoo.FLModel` clients train.
      eval_fn: params -> scalar test accuracy.
      cfg: federation configuration; ``cfg.method`` names a registered
        strategy unless ``strategy`` is given.  Engine, backend, fleet,
        scenario and ``rho`` are validated here, as the reference does.
      strategy: optional pre-built :class:`Strategy` (overrides cfg.method).
      fleet: optional device table for the substrate engine (the parity
        tests pass the reference's, see
        :func:`repro_torch.carry.fleet_from_jax`); default: sampled from
        ``cfg.sim.fleet`` and ``cfg.sim.seed``.
    """

    _ENGINES = ("python", "scan", "semi_async")

    def __init__(self, model: FLModel, eval_fn: Callable[[dict], torch.Tensor],
                 cfg: FederationConfig, strategy: Strategy | None = None,
                 fleet: sim_mod.DeviceFleet | None = None):
        if cfg.engine not in self._ENGINES:
            raise ValueError(
                f"unknown engine {cfg.engine!r}; registered engines: "
                f"{self._ENGINES} (event_driven waits for ROADMAP queue "
                "A.3b)")
        try:
            bk.get_backend(cfg.backend)
        except KeyError:
            raise ValueError(
                f"unknown backend {cfg.backend!r}; registered backends: "
                f"{bk.available_backends()}") from None
        if cfg.sim.fleet not in sim_mod.available_fleets():
            raise ValueError(
                f"unknown fleet profile {cfg.sim.fleet!r}; registered "
                f"profiles: {sim_mod.available_fleets()}")
        if cfg.sim.scenario not in sim_mod.available_scenarios():
            raise ValueError(
                f"unknown scenario {cfg.sim.scenario!r}; registered "
                f"scenarios: {sim_mod.available_scenarios()}")
        if not 0.0 <= cfg.sim.rho <= 1.0:           # also rejects NaN
            raise ValueError(
                f"rho={cfg.sim.rho} must be in [0, 1] (fleet-data coupling "
                f"strength; 0 = independent sampling)")
        validate_dp(cfg.client)
        self.model = model
        self.eval_fn = eval_fn
        self.cfg = cfg
        self.strategy = strategy if strategy is not None else \
            strategies.make_strategy(cfg.method, n_clients=cfg.n_clients,
                                     n_coalitions=cfg.n_coalitions,
                                     backend=cfg.backend)
        self.fleet = fleet if fleet is not None else sim_mod.make_fleet(
            cfg.sim.fleet, cfg.n_clients, seed=cfg.sim.seed)

    def _shuffles(self, r: int, n: int, device, generator, draws) -> torch.Tensor:
        if draws is not None:
            return torch.as_tensor(np.asarray(draws.shuffles[r]),
                                   dtype=torch.long, device=device)
        u = torch.rand((self.cfg.n_clients, self.cfg.client.epochs, n),
                       generator=generator)
        return torch.argsort(u, dim=-1).to(device)

    def _bary_of(self, res: RoundResult) -> torch.Tensor:
        """The (n_groups, D) per-group models of the round: a coalition
        rule's barycenters, or θ broadcast to every group for a flat rule
        (which serves every client the global model)."""
        if res.barycenters is not None:
            return res.barycenters
        return res.theta[None, :].expand(self.strategy.n_groups, -1)

    def _radius_of(self, metrics: RoundMetrics, device) -> torch.Tensor:
        """The strategy's intra radius, zeros when a rule reports None."""
        if metrics.radius is not None:
            return metrics.radius
        return torch.zeros((self.strategy.n_groups,), dtype=torch.float32,
                           device=device)

    def _availability(self, generator, draws) -> sim_mod.AvailabilityDraws:
        """The run's availability draws: injected, or drawn in bulk from a
        generator of their own (the client draws stay those of scan)."""
        if draws is not None and draws.availability is not None:
            return draws.availability
        seed = (generator.initial_seed() if generator is not None
                else self.cfg.sim.seed)
        gen = torch.Generator().manual_seed(
            (seed + sim_mod.AVAILABILITY_STREAM) % 2**63)
        return sim_mod.draw_availability(self.fleet, self.cfg.sim.participation,
                                         self.cfg.rounds, gen)

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
        cfg, scfg, strategy = self.cfg, self.cfg.sim, self.strategy
        layout = self.model.layout
        device = next(iter(client_data.values())).device
        n_local = next(iter(client_data.values())).shape[1]
        semi = cfg.engine == "semi_async"
        if semi:
            # everything the substrate reads goes to the device up front:
            # the rounds below never read a value back to the host
            avail = self._availability(generator, draws)
            stay = torch.tensor(np.asarray(avail.stay), dtype=torch.bool,
                                device=device)
            fresh = torch.tensor(np.asarray(avail.fresh), dtype=torch.bool,
                                 device=device)
            astate = sim_mod.init_availability(avail.online, device)
            model_bytes = pytree.tree_bytes(init_params)
            dev_time = sim_mod.device_round_time(self.fleet, model_bytes,
                                                 scfg.local_work, device)
            tau = torch.zeros((cfg.n_clients,), dtype=torch.int32,
                              device=device)
        rows = []
        gp, state, prev_assign, prev_bary = init_params, None, None, None
        for r in range(cfg.rounds):
            t0 = time.perf_counter()
            perms = self._shuffles(r, n_local, device, generator, draws)
            stacked, losses = local_phase(self.model.loss_fn, gp, client_data,
                                          perms, cfg.client)
            w = pytree.client_matrix(stacked, layout)
            mask = eff = None
            if semi and r == 0:             # the census fills the buffer
                buf = w
                mask = torch.ones((cfg.n_clients,), dtype=torch.bool,
                                  device=device)
            elif semi:
                mask, astate = sim_mod.sample_mask(
                    astate, stay[r - 1], fresh[r - 1], device_time=dev_time,
                    deadline=scfg.deadline)
                torch.where(mask[:, None], w, buf, out=buf)
                tau.add_(1).masked_fill_(mask, 0)
                # tau == 0 decays to exactly 1.0: under full participation
                # eff is all ones and the round equals the synchronous one
                eff = sim_mod.staleness_weights(tau, scfg.staleness_alpha)
            _sync(device)
            t1 = time.perf_counter()
            if r == 0:
                state = strategy.init_state(
                    w, perm=None if draws is None else draws.center_perm,
                    generator=generator)
            res = strategy.round(buf if eff is not None else w, state,
                                 mask=eff)
            _sync(device)
            t2 = time.perf_counter()
            state = res.state
            gp = pytree.unflatten(res.theta, layout, gp)
            bary = self._bary_of(res)
            assignment = res.metrics.assignment
            loss = torch.mean(losses)
            if eff is not None:
                # participants' mean loss through the same mean (the scale
                # is exactly 1.0 at full participation)
                m = mask.float()
                scale = cfg.n_clients / torch.clamp(torch.sum(m), min=1.0)
                loss = torch.mean(losses * (m * scale))
            row = {"loss": loss, "acc": self.eval_fn(gp),
                   "assignment": assignment, "counts": res.metrics.counts,
                   "entropy": obs_metrics.size_entropy(res.metrics.counts),
                   "radius": self._radius_of(res.metrics, device),
                   "local_s": t1 - t0, "server_s": t2 - t1}
            if r == 0:       # the census has no previous round to compare to
                row["churn"] = 0.0
                row["drift"] = torch.zeros(strategy.n_groups)
            else:
                row["churn"] = obs_metrics.membership_churn(assignment,
                                                            prev_assign)
                row["drift"] = obs_metrics.barycenter_drift(bary, prev_bary)
            if semi:
                # the census round has no deadline to wait out
                sim_t, wan, edge = sim_mod.round_stats(
                    mask, dev_time, model_bytes, strategy.n_groups,
                    strategy.hierarchical,
                    deadline=scfg.deadline if r else float("inf"))
                row.update(sim_time=sim_t, wan_bytes=wan, edge_bytes=edge,
                           participation=mask.float())
            rows.append({k: v.detach().cpu().numpy() if torch.is_tensor(v)
                         else np.asarray(v) for k, v in row.items()})
            prev_assign, prev_bary = assignment, bary
        trace = Trace(**{f: np.stack([row[f] for row in rows])
                         for f in Trace._fields if f in rows[0]})
        return gp, History(trace=trace)
