"""Strategy-driven federation engine.

The paper's outer loop (Algorithm 1) is one
:mod:`repro_torch.core.strategies` entry; this module is the *engine* that
drives a registered strategy:

  broadcast θ -> vmapped ClientUpdate over all clients -> (N, D) weight
  matrix -> ``strategy.round(w, state)`` -> new θ + next state + metrics

Round 0 is the census: every client trains from θ^(0), the strategy state is
initialised from those weights (Step I for coalition rules), and the first
aggregation runs on them.  Rounds (or events) 1 .. R-1 follow.

Four engines run that round program:

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
                 :class:`Trace`.
  ``'event_driven'`` — the continuous-time variant with no round barrier:
                 each step pops the devices whose download + compute +
                 upload cycle completes next off a queue of completion
                 times; those online at that instant deliver, staleness is
                 measured in simulated seconds since each buffered row was
                 delivered, and every attempt charges the device's
                 ``sim.device_event_energy`` to an energy budget.  A device
                 that cannot afford another cycle retires; once all have,
                 the clock freezes and the remaining events record zero
                 participation.  It runs ``sim.max_events`` steps after the
                 census (default ``rounds - 1``).

On the ``ideal`` fleet (with an unbounded budget) every substrate step is an
exact no-op and both substrate engines equal ``scan`` bit for bit.

Two optional tiers compose with every engine:

* **Cohort mode** (``FederationConfig.fleet_size``, ``scan``/``python``
  only): a fleet of N devices (up to millions) exists only as its device
  table; each round trains a cohort of C = ``n_clients`` devices drawn by
  the hierarchical Gumbel top-k sampler (:mod:`repro_torch.sim.cohort`),
  the whole (R, C) schedule sampled on the device before round 0.  Device
  i trains on data shard ``i % S`` (S shards in ``client_data``).
* **Attacks and DP**: a registered :mod:`repro_torch.sim.attacks` model
  poisons its adversaries' batches before local training and their
  updates after flattening (and after the DP path of
  :func:`repro_torch.core.client.privatize`); every round then reports the
  adversary mask, the quarantine fraction and the contamination bound,
  O(N·K) algebra over the ``med_d2`` the coalition round already has.

Three host-side hooks of :meth:`Federation.run` run between rounds, on
values the round already read back, so they leave the numerics untouched:

* ``snapshot_every=k`` + ``store`` — publish a round snapshot (θ, every
  per-coalition barycenter, the round's assignment) into a
  :class:`repro_torch.serve.ModelStore` at rounds ``r % k == 0`` and the
  final round, for a serving front end to hot-swap.
* ``ckpt_every=k`` + ``ckpt_dir`` — write a ``save_federation`` checkpoint
  with the whole resume carry (θ, strategy state, barycenters, the
  substrate's buffers and ledgers, the generator states) and the trace so
  far; ``resume=True`` restores the latest and continues to the same
  :class:`History` as an uninterrupted run.
* ``metrics_every=k`` + ``sink`` — stream ``run_meta`` and per-round
  ``round`` records (the reference's keys) into a
  :mod:`repro_torch.obs.ledger` sink.

* **Mesh mode** (``FederationConfig.mesh``): the coalition round runs
  split along D over the ``data`` ranks of a device mesh
  (:mod:`repro_torch.core.sharded`), each rank on its contiguous column
  tile of W with all-reduces of (N, K) partials between the passes.  Every
  rank runs the same local phase from the same seeds; after the round θ is
  gathered from the ranks' tiles (the round's one O(D) collective, inside
  ``server_s``), and the barycenters only when a snapshot or a checkpoint
  needs them (the drift metric sums its partial squares instead).  Rank 0
  alone writes the ledger, snapshots and checkpoints.  Flat rules keep
  their dense round.  On a one-rank mesh the run equals the dense run bit
  for bit.

Randomness: each round draws every client's per-epoch shuffles, and round 0
draws the Step-I permutation, from one ``torch.Generator`` in that order.
Everything else draws from generators of its own, seeded from the run
generator's seed offset by a stream tag, so the client draws stay those of
``scan``: the availability draws (``sim.AVAILABILITY_STREAM``, in bulk
before round 0), the cohort Gumbel rows (``sim.COHORT_STREAM``), the attack
noise (``sim.ATTACK_STREAM``, on the run's device) and the DP noise
(:data:`DP_STREAM`, on the run's device).  :class:`Draws` injects them all
instead (the parity tests pass the reference's threefry draws).

Per round the engine records the loss/accuracy, the coalition structure,
the dynamics block (churn, size entropy, intra radius, barycenter drift)
and the seconds spent in the local phase and in the server step (each ended
by a device synchronise; the server step is the strategy's round alone).
No value is read back to the host between the start of a round's local
phase and the end of its server step.  Each round marks four of its phases
as ``record_function`` ranges, one after another, which a running
``torch.profiler`` puts on its clock: ``fl.shuffle``, ``fl.server``,
``fl.eval`` and ``fl.readback``.  The local phase is the gap from
``fl.shuffle``'s end to ``fl.server``'s start; it gets no range of its own,
since a profiler running a range over its tens of thousands of launches
slows each of them.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import sim as sim_mod
from repro_torch.core import backends as bk
from repro_torch.core import pytree, strategies
from repro_torch.core.client import (ClientConfig, dp_enabled, local_phase,
                                     privatize, validate_dp)
from repro_torch.core.strategies import RoundMetrics, RoundResult, Strategy
from repro_torch.models.zoo import FLModel
from repro_torch.obs import ledger as obs_ledger
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import privacy as obs_privacy

#: the port's stream tag of the DP noise (the reference splits that key off
#: each client's own); the DP generator's seed is offset by it
DP_STREAM = 0xD9A1
#: the trace's host timings: the run ledger leaves them out (the
#: reference's records do not have them), and two runs of one seed agree on
#: every other field bit for bit
TIMING_FIELDS = ("local_s", "server_s")


def bytes_per_param(w: torch.Tensor) -> int:
    """On-wire bytes per parameter of a single-dtype tensor (a bf16 model
    moves half the bytes of an f32 one).  The engine bills whole models by
    :func:`pytree.tree_bytes`, leaf by leaf."""
    return w.element_size()


class FederationConfig(NamedTuple):
    n_clients: int = 10                # cohort width C in cohort mode
    n_coalitions: int = 3
    rounds: int = 30
    method: str = "coalition"          # any registered strategy name
    client: ClientConfig = ClientConfig()
    backend: str = "stream"            # distance/barycenter backend name
    engine: str = "scan"               # 'scan' | 'python' | 'semi_async'
    #                                    | 'event_driven'
    sim: sim_mod.SimConfig = sim_mod.SimConfig()   # IoT substrate knobs
    #: registered fleet size N of cohort mode (each round samples a cohort
    #: of ``n_clients`` devices out of N); None = dense mode
    fleet_size: int | None = None
    #: registered byzantine attack name; None = every client honest
    attack: str | None = None
    #: fraction of the fleet compromised (mask fixed per fleet and
    #: ``sim.seed``); 0.0 with an attack set gates every hook off
    adv_frac: float = 0.0
    #: adversary-capability rank coupling in [-1, 1] (+1 = the strongest
    #: devices are compromised, -1 the weakest, 0 seeded-random)
    rho_adv: float = 0.0
    #: device-mesh spec (:func:`repro_torch.launch.mesh.parse_mesh`:
    #: ``"data=2"`` | ``"host"`` | ``"production"``) to split the coalition
    #: round over; None = the dense round.  Validated at construction.
    mesh: str | None = None


class Draws(NamedTuple):
    """Injected randomness for a run (None: drawn as without injection).

    ``shuffles[r]`` is step r's (N, E, n) per-client, per-epoch sample
    order; ``center_perm`` the (N,) Step-I permutation of round 0;
    ``availability`` the substrate engines' census and per-step
    availability booleans; ``cohorts`` the (R, C) cohort-mode schedule;
    ``attack_noise[r]`` and ``dp_noise[r]`` step r's (N, D) standard normal
    draws of the ``gaussian_noise`` attack and of the DP path.
    """

    shuffles: Sequence[Any]
    center_perm: Any
    availability: sim_mod.AvailabilityDraws | None = None
    cohorts: Any = None
    attack_noise: Sequence[Any] | None = None
    dp_noise: Sequence[Any] | None = None


class Trace(NamedTuple):
    """Stacked per-round numpy arrays for R rounds (events under
    ``event_driven``, where ``sim_time`` is the seconds since the previous
    event and ``event_time`` the absolute timestamp)."""

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
    # --- semi_async / event_driven (None on scan / python) -------------------
    sim_time: np.ndarray | None = None       # (R,) simulated seconds a step
    wan_bytes: np.ndarray | None = None      # (R,) bytes over the WAN link
    edge_bytes: np.ndarray | None = None     # (R,) bytes over edge links
    participation: np.ndarray | None = None  # (R, N) 0/1 participation mask
    # --- event_driven only ---------------------------------------------------
    event_time: np.ndarray | None = None        # (R,) absolute sim seconds
    energy_spent: np.ndarray | None = None      # (R, N) cumulative joules
    energy_exhausted: np.ndarray | None = None  # (R, N) 1 = device retired
    # --- cohort mode only ----------------------------------------------------
    cohort: np.ndarray | None = None            # (R, C) sampled device ids
    # --- attack runs only ----------------------------------------------------
    adversary: np.ndarray | None = None      # (R, N) 0/1 compromised rows
    quarantine: np.ndarray | None = None     # (R,) adversaries embedded
    #                                          among honest clients
    contamination: np.ndarray | None = None  # (R,) honest-barycenter bound


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
    def radius(self) -> list[list[float]]:
        """Per-round per-coalition intra radius (zeros for flat rules)."""
        return self.trace.radius.astype(float).tolist()

    @property
    def drift(self) -> list[list[float]]:
        return self.trace.drift.astype(float).tolist()

    @staticmethod
    def _float_list(arr) -> list[float] | None:
        return None if arr is None else [float(x) for x in arr]

    @staticmethod
    def _nested(arr, kind) -> list | None:
        return None if arr is None else arr.astype(kind).tolist()

    @property
    def sim_times(self) -> list[float] | None:
        """Per-round simulated seconds (substrate engines only)."""
        return self._float_list(self.trace.sim_time)

    @property
    def wan_bytes(self) -> list[float] | None:
        return self._float_list(self.trace.wan_bytes)

    @property
    def edge_bytes(self) -> list[float] | None:
        return self._float_list(self.trace.edge_bytes)

    @property
    def participation(self) -> list[list[int]] | None:
        return self._nested(self.trace.participation, int)

    @property
    def event_times(self) -> list[float] | None:
        """Absolute simulated timestamp of each event (event_driven only)."""
        return self._float_list(self.trace.event_time)

    @property
    def energy_spent(self) -> list[list[float]] | None:
        """Per-device cumulative joules, per event (event_driven only)."""
        return self._nested(self.trace.energy_spent, float)

    @property
    def energy_exhausted(self) -> list[list[int]] | None:
        """Per-device retirement flags, per event (event_driven only)."""
        return self._nested(self.trace.energy_exhausted, int)

    @property
    def cohorts(self) -> list[list[int]] | None:
        """Per-round sampled fleet device ids (cohort mode only)."""
        return self._nested(self.trace.cohort, int)

    @property
    def adversary(self) -> list[list[int]] | None:
        """Per-round 0/1 compromised-row mask (attack runs only)."""
        return self._nested(self.trace.adversary, int)

    @property
    def quarantine(self) -> list[float] | None:
        """Per-round fraction of adversaries embedded among honest clients."""
        return self._float_list(self.trace.quarantine)

    @property
    def contamination(self) -> list[float] | None:
        """Per-round honest-barycenter contamination bound."""
        return self._float_list(self.trace.contamination)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Noise:
    """Step r's standard normal draws shaped like a tensor: injected
    (``rows[r]``) or drawn from ``generator`` on the tensor's device."""

    def __init__(self, rows: Sequence[Any] | None,
                 generator: torch.Generator | None):
        self.rows, self.generator = rows, generator

    def draw(self, r: int, like: torch.Tensor) -> torch.Tensor:
        if self.rows is not None:
            return torch.tensor(np.asarray(self.rows[r]), dtype=like.dtype,
                                device=like.device)
        return torch.randn(like.shape, generator=self.generator,
                           device=like.device, dtype=like.dtype)


class _Substrate:
    """A substrate engine's state on the run's device.

    ``census(w)`` fills the buffer with the round-0 weights, ``step(r, w)``
    applies step r's availability to it and returns ``(matrix to
    aggregate, weights, participation mask)``, and ``row(r, mask)`` gives
    the step's substrate trace fields.
    """

    def __init__(self, fed: "Federation", avail: sim_mod.AvailabilityDraws,
                 device: torch.device, model_bytes: int):
        self.scfg, self.model_bytes = fed.cfg.sim, model_bytes
        self.n_groups = fed.strategy.n_groups
        self.hierarchical = fed.strategy.hierarchical
        # everything the substrate reads goes to the device up front: the
        # steps never read a value back to the host
        self.stay = torch.tensor(np.asarray(avail.stay), dtype=torch.bool,
                                 device=device)
        self.fresh = torch.tensor(np.asarray(avail.fresh), dtype=torch.bool,
                                  device=device)
        self.astate = sim_mod.init_availability(avail.online, device)
        self.dev_time = sim_mod.device_round_time(
            fed.fleet, model_bytes, self.scfg.local_work, device)
        self.ones = torch.ones((fed.cfg.n_clients,), dtype=torch.bool,
                               device=device)
        self.buf = None

    def _stats(self, mask, deadline=float("inf")):
        return sim_mod.round_stats(mask, self.dev_time, self.model_bytes,
                                   self.n_groups, self.hierarchical,
                                   deadline=deadline)

    #: the tensors a round leaves for the next (the resume carry)
    CARRY: tuple[str, ...] = ("buf",)

    def carry(self) -> dict:
        return {"online": self.astate.online,
                **{f: getattr(self, f) for f in self.CARRY}}

    def load(self, carry: dict) -> None:
        self.astate = sim_mod.AvailabilityState(online=carry["online"])
        for f in self.CARRY:
            setattr(self, f, carry[f])


class _SemiAsync(_Substrate):
    """``semi_async``: availability and a deadline give each round's mask;
    absent rows keep their buffered update, ``tau`` rounds old."""

    CARRY = ("buf", "tau")

    def __init__(self, fed, avail, device, model_bytes):
        super().__init__(fed, avail, device, model_bytes)
        self.tau = torch.zeros_like(self.ones, dtype=torch.int32)

    def census(self, w):
        self.buf = w
        return w, None, self.ones

    def step(self, r, w):
        mask, self.astate = sim_mod.sample_mask(
            self.astate, self.stay[r - 1], self.fresh[r - 1],
            device_time=self.dev_time, deadline=self.scfg.deadline)
        torch.where(mask[:, None], w, self.buf, out=self.buf)
        self.tau.add_(1).masked_fill_(mask, 0)
        # tau == 0 decays to exactly 1.0: under full participation the
        # weights are all ones and the round equals the synchronous one
        return self.buf, sim_mod.staleness_weights(
            self.tau, self.scfg.staleness_alpha), mask

    def row(self, r, mask):
        # the census round has no deadline to wait out
        sim_t, wan, edge = self._stats(
            mask, self.scfg.deadline if r else float("inf"))
        return {"sim_time": sim_t, "wan_bytes": wan, "edge_bytes": edge,
                "participation": mask.float()}


class _EventDriven(_Substrate):
    """The ``event_driven`` engine's queue, clock and energy ledger.

    Per event: ``fire`` = the devices whose completion time is the queue's
    minimum; ``deliver`` = ``fire`` and online at that instant (no
    deadline); the buffer takes the delivered rows, weighted by
    ``(1 + age_s)^-alpha`` with age in simulated seconds; then every fired
    device pays its cycle's joules and retires once its energy is below the
    next cycle's cost.  Ledgers update in place.
    """

    CARRY = ("buf", "energy", "spent", "alive", "next_t", "last_t",
             "clock", "t_now")

    def __init__(self, fed, avail, device, model_bytes):
        super().__init__(fed, avail, device, model_bytes)
        self.e_event = sim_mod.device_event_energy(
            fed.fleet, model_bytes, self.scfg.local_work).to(device)

    def census(self, w):
        self.buf = w
        t0 = self._stats(self.ones)[0]
        # The census is forced, so a device pays for it only up to its
        # budget (the ledger never overdraws), and one that cannot afford
        # the next full cycle starts retired.
        paid0 = torch.clamp(self.e_event, max=float(self.scfg.energy_budget))
        self.energy = torch.full_like(self.e_event,
                                      float(self.scfg.energy_budget)) - paid0
        self.spent = paid0
        self.alive = self.energy >= self.e_event
        self.next_t = torch.where(self.alive, t0 + self.dev_time,
                                  torch.full_like(self.dev_time, np.inf))
        self.last_t = torch.full_like(self.dev_time, 0.0) + t0
        self.clock = self.t_now = t0
        return w, None, self.ones

    def step(self, r, w):
        online, self.astate = sim_mod.sample_mask(
            self.astate, self.stay[r - 1], self.fresh[r - 1])
        # pop the next completion cohort; an all-inf queue (every device
        # retired) fires nothing and freezes the clock
        t_next = torch.min(self.next_t)
        fired_any = torch.isfinite(t_next)
        self.t_now = torch.where(fired_any, t_next, self.clock)
        self.fire = (self.next_t == t_next) & fired_any
        deliver = self.fire & online
        torch.where(deliver[:, None], w, self.buf, out=self.buf)
        torch.where(deliver, self.t_now, self.last_t, out=self.last_t)
        # a row delivered this event has age exactly 0, weight exactly 1.0
        return self.buf, sim_mod.staleness_weights(
            self.t_now - self.last_t, self.scfg.staleness_alpha), deliver

    def row(self, r, mask):
        sim_t, wan, edge = self._stats(mask)
        if r:
            paid = self.fire.float() * self.e_event
            self.energy.sub_(paid)
            self.spent.add_(paid)
            self.alive = self.energy >= self.e_event
            torch.where(self.fire,
                        torch.where(self.alive, self.t_now + self.dev_time,
                                    torch.full_like(self.dev_time, np.inf)),
                        self.next_t, out=self.next_t)
            sim_t = self.t_now - self.clock
            self.clock = self.t_now
        return {"sim_time": sim_t, "wan_bytes": wan, "edge_bytes": edge,
                "participation": mask.float(), "event_time": self.t_now,
                "energy_spent": self.spent.clone(),
                "energy_exhausted": (~self.alive).float()}


class Federation:
    """A federation = one strategy + one engine over a client population.

    Args:
      model: the :class:`~repro_torch.models.zoo.FLModel` clients train.
      eval_fn: params -> scalar test accuracy.
      cfg: federation configuration; ``cfg.method`` names a registered
        strategy unless ``strategy`` is given.  Engine (``scan``,
        ``python``, ``semi_async`` or ``event_driven``), backend, fleet,
        scenario, ``rho``, the energy budget, the event budget, cohort
        mode and the attack are validated here, as the reference does.
      strategy: optional pre-built :class:`Strategy` (overrides cfg.method).
      fleet: optional device table, ``fleet_size`` rows in cohort mode and
        ``n_clients`` otherwise (the parity tests pass the reference's, see
        :func:`repro_torch.carry.fleet_from_jax`); default: sampled from
        ``cfg.sim.fleet`` and ``cfg.sim.seed``.
      attack: optional pre-built :class:`repro_torch.sim.Attack` (overrides
        cfg.attack; the way to set an attack's hyper-parameters).
    """

    _ENGINES = ("event_driven", "python", "scan", "semi_async")

    def __init__(self, model: FLModel, eval_fn: Callable[[dict], torch.Tensor],
                 cfg: FederationConfig, strategy: Strategy | None = None,
                 fleet: sim_mod.DeviceFleet | None = None,
                 attack: sim_mod.Attack | None = None):
        if cfg.engine not in self._ENGINES:
            raise ValueError(
                f"unknown engine {cfg.engine!r}; registered engines: "
                f"{self._ENGINES}")
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
        if not cfg.sim.energy_budget >= 0:          # also rejects NaN
            raise ValueError(
                f"energy_budget={cfg.sim.energy_budget} must be >= 0 "
                f"(joules; inf = unconstrained)")
        if cfg.sim.max_events is not None and cfg.sim.max_events < 0:
            raise ValueError(
                f"max_events={cfg.sim.max_events} must be >= 0 "
                f"(None = rounds - 1)")
        if cfg.fleet_size is not None:
            if cfg.fleet_size < cfg.n_clients:
                raise ValueError(
                    f"fleet_size={cfg.fleet_size} must be >= n_clients="
                    f"{cfg.n_clients} (the cohort is sampled from the fleet)")
            if cfg.engine not in ("scan", "python"):
                raise ValueError(
                    f"cohort mode (fleet_size set) supports the 'scan' and "
                    f"'python' engines; {cfg.engine!r} carries dense "
                    "fleet-sized buffers (staleness/energy ledgers) that do "
                    "not cohortize")
            if cfg.sim.scenario != "independent" or cfg.sim.rho != 0.0:
                raise ValueError(
                    "cohort mode requires the 'independent' scenario with "
                    "rho=0 — coupled scenarios partition data jointly with "
                    "a dense fleet")
        if not 0.0 <= cfg.adv_frac < 1.0:       # also rejects NaN
            raise ValueError(
                f"adv_frac={cfg.adv_frac} must be in [0, 1) (a fully "
                "compromised federation has no honest signal to aggregate)")
        if not -1.0 <= cfg.rho_adv <= 1.0:      # also rejects NaN
            raise ValueError(
                f"rho_adv={cfg.rho_adv} must be in [-1, 1] (adversary-"
                "capability rank coupling; 0 = random placement)")
        if attack is None and cfg.attack is not None:
            attack = sim_mod.make_attack(cfg.attack)     # raises on typo
        if cfg.adv_frac > 0.0 and attack is None:
            raise ValueError(
                f"adv_frac={cfg.adv_frac} > 0 requires an attack "
                f"(cfg.attack or the attack= argument); available: "
                f"{sim_mod.available_attacks()}")
        validate_dp(cfg.client)
        self.model = model
        self.eval_fn = eval_fn
        self.cfg = cfg
        self.attack = attack
        self.strategy = strategy if strategy is not None else \
            strategies.make_strategy(cfg.method, n_clients=cfg.n_clients,
                                     n_coalitions=cfg.n_coalitions,
                                     backend=cfg.backend)
        #: the parsed DeviceMesh when cfg.mesh names one (a bad spec or a
        #: world of another size fails here, not mid-run); a coalition
        #: rule's backend is rewrapped so its round runs on this rank's
        #: column tile of W and returns barycenter and θ tiles.  Flat rules
        #: keep their dense round.
        self.mesh, self._tiled, self.rank = None, False, 0
        if cfg.mesh is not None:
            import torch.distributed as dist

            from repro_torch.core import sharded
            from repro_torch.launch import mesh as mesh_lib

            self.mesh = mesh_lib.parse_mesh(cfg.mesh)
            self.rank = dist.get_rank()
            if getattr(self.strategy, "backend", None) is not None:
                self.strategy = dataclasses.replace(
                    self.strategy, backend=sharded.sharded_backend(
                        self.strategy.backend, self.mesh))
                self._tiled = True
        n_fleet = cfg.fleet_size or cfg.n_clients
        self.fleet = fleet if fleet is not None else sim_mod.make_fleet(
            cfg.sim.fleet, n_fleet, seed=cfg.sim.seed)
        if len(self.fleet.compute_s) != n_fleet:
            raise ValueError(
                f"the fleet has {len(self.fleet.compute_s)} devices; this "
                f"configuration needs {n_fleet}")
        #: (N_fleet,) bool compromised-device mask (None without an
        #: attack), deterministic in (fleet, adv_frac, rho_adv, sim.seed)
        self.adversaries = None if attack is None else sim_mod.adversary_mask(
            self.fleet, cfg.adv_frac, cfg.rho_adv, seed=cfg.sim.seed)

    def _n_steps(self) -> int:
        """Steps after the round-0 census (events for event_driven)."""
        if self.cfg.engine == "event_driven" and \
                self.cfg.sim.max_events is not None:
            return self.cfg.sim.max_events
        return self.cfg.rounds - 1

    def _stream(self, tag: int, generator, device="cpu") -> torch.Generator:
        """A generator of its own for one stream: the run generator's seed
        (``sim.seed`` without one) offset by ``tag``."""
        seed = (generator.initial_seed() if generator is not None
                else self.cfg.sim.seed)
        return torch.Generator(device=device).manual_seed(
            (seed + tag) % 2**63)

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

    def _whole(self, tile: torch.Tensor, d: int) -> torch.Tensor:
        """A whole (..., D) tensor from this rank's column tile under a
        mesh (an all-gather every rank must join); the tensor itself
        otherwise."""
        if not self._tiled:
            return tile
        from repro_torch.core import sharded

        return sharded.gather_cols(tile, self.mesh, d)

    def _drift(self, bary: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
        """The barycenter drift; under a mesh the tiles' partial squares are
        summed over the ranks before the square root."""
        if not self._tiled:
            return obs_metrics.barycenter_drift(bary, prev)
        from repro_torch.core import sharded

        diff = bary.float() - prev.float()
        sq = sharded.summed(torch.sum(diff * diff, dim=1), self.mesh)
        return torch.sqrt(torch.clamp(sq, min=0.0))

    def _radius_of(self, metrics: RoundMetrics, device) -> torch.Tensor:
        """The strategy's intra radius, zeros when a rule reports None."""
        if metrics.radius is not None:
            return metrics.radius
        return torch.zeros((self.strategy.n_groups,), dtype=torch.float32,
                           device=device)

    def _attack_row(self, res: RoundResult, adv) -> dict:
        """The attack block of a round's trace row (empty when clean):
        O(N·K) algebra over the assignment and the coalition round's
        ``med_d2``; flat rules, which have no barycenter geometry, report
        contamination 0.0."""
        if adv is None:
            return {}
        k = self.strategy.n_groups
        q = obs_metrics.quarantine_fraction(res.metrics.assignment, adv, k)
        if res.metrics.med_d2 is not None:
            c = obs_metrics.contamination(res.metrics.med_d2,
                                          res.metrics.assignment, adv, k)
        else:
            c = torch.zeros((), dtype=torch.float32, device=adv.device)
        return {"adversary": adv, "quarantine": q, "contamination": c}

    def _substrate(self, steps, generator, draws, device, model_bytes):
        """The substrate engine's state (None on scan / python), its
        availability draws injected or drawn in bulk from their own
        generator (the client draws stay those of scan)."""
        engines = {"semi_async": _SemiAsync, "event_driven": _EventDriven}
        if self.cfg.engine not in engines:
            return None
        avail = None if draws is None else draws.availability
        if avail is None:
            avail = sim_mod.draw_availability(
                self.fleet, self.cfg.sim.participation, steps + 1,
                self._stream(sim_mod.AVAILABILITY_STREAM, generator))
        return engines[self.cfg.engine](self, avail, device, model_bytes)

    def _cohort_schedule(self, steps, generator, draws, device):
        """The run's (steps + 1, C) cohort ids on the device (row 0 seats
        the census), or None in dense mode: injected, or sampled from
        Gumbel rows of their own generator."""
        if self.cfg.fleet_size is None:
            return None
        weights = sim_mod.effective_p(self.fleet, self.cfg.sim.participation
                                      ).to(device)
        n_pos = int(torch.sum(weights > 0))
        if n_pos < self.cfg.n_clients:
            raise ValueError(
                f"fleet has only {n_pos} devices with positive effective "
                f"availability; cannot seat a cohort of {self.cfg.n_clients}")
        if draws is not None and draws.cohorts is not None:
            return torch.tensor(np.asarray(draws.cohorts), dtype=torch.long,
                                device=device)
        return sim_mod.sample_cohorts(
            weights, steps + 1, self.cfg.n_clients,
            generator=self._stream(sim_mod.COHORT_STREAM, generator))

    def _local_phase(self, r, gp, client_data, perms, ids, adv, noise):
        """Broadcast + vmapped ClientUpdate -> ((C, D) weights, (C,) losses).

        In cohort mode device i trains on data shard ``i % S``.  With an
        attack, the round's adversary rows poison their batch before
        training and transform their update after the DP path; both hooks
        are the identity where the mask is 0.
        """
        cfg = self.cfg
        if ids is not None:
            client_data = {k: v[ids % v.shape[0]]
                           for k, v in client_data.items()}
        if adv is not None:
            client_data = self.attack.poison(client_data, adv)
        stacked, losses = local_phase(self.model.loss_fn, gp, client_data,
                                      perms, cfg.client)
        w = pytree.client_matrix(stacked, self.model.layout)
        if dp_enabled(cfg.client) or adv is not None:
            theta = pytree.flatten(gp, self.model.layout)
        if dp_enabled(cfg.client):
            w = privatize(w, theta, cfg.client,
                          noise=(noise["dp"].draw(r, w)
                                 if cfg.client.dp_sigma > 0.0 else None))
        if adv is not None:
            w = self.attack.transform(w, theta, adv,
                                      lambda: noise["attack"].draw(r, w))
        return w, losses

    # -- host-side hooks ------------------------------------------------------

    @staticmethod
    def _fires(r: int, every: int | None, total: int) -> bool:
        """Hook cadence: every ``every`` rounds from round 0, plus the final
        round (the serve/resume consumer must always see the finished run)."""
        return every is not None and (r % every == 0 or r == total)

    def _publish(self, store, round_: int, gp, bary, row) -> None:
        store.publish(round_, pytree.to_ref_tree(gp, self.model.layout),
                      bary, assignment=row["assignment"],
                      counts=row["counts"],
                      extra_meta={"engine": self.cfg.engine,
                                  "method": self.cfg.method,
                                  "n_clients": self.cfg.n_clients})

    def _run_meta_record(self, sub, model_bytes: int) -> dict:
        """The ledger's ``run_meta`` header (first record of every run); on
        the substrate engines it carries the per-device cycle seconds the
        timeline draws device busy spans from."""
        cfg = self.cfg
        steps = self._n_steps() + 1
        rec = {"schema": obs_ledger.OBS_SCHEMA, "kind": obs_ledger.RUN_META,
               "engine": cfg.engine, "method": cfg.method,
               "n_clients": cfg.n_clients,
               "n_groups": self.strategy.n_groups, "steps": steps}
        if cfg.fleet_size is not None:
            rec["fleet_size"] = cfg.fleet_size
        if self.attack is not None:
            rec.update(
                attack=self.attack.name, attack_params=self.attack.params,
                adv_frac=cfg.adv_frac, rho_adv=cfg.rho_adv,
                n_adversaries=int(np.asarray(self.adversaries).sum()))
        if dp_enabled(cfg.client):
            eps = obs_privacy.gaussian_epsilon(cfg.client.dp_sigma, steps)
            rec.update(
                dp_sigma=cfg.client.dp_sigma,
                # null = unconstrained (inf is not valid RFC 8259 JSON)
                dp_clip=(cfg.client.dp_clip
                         if math.isfinite(cfg.client.dp_clip) else None),
                dp_epsilon=eps if math.isfinite(eps) else None)
        if sub is not None:
            rec.update(fleet=cfg.sim.fleet, scenario=cfg.sim.scenario,
                       model_bytes=int(model_bytes),
                       device_time_s=sub.dev_time)
        return rec

    def _emit_rows(self, sink, rows: list, r_start: int, every: int,
                   total: int) -> None:
        """One ``round`` record per trace row the cadence selects (row i is
        round ``r_start + i``), with the reference's keys."""
        for i, row in enumerate(rows):
            r = r_start + i
            if not self._fires(r, every, total):
                continue
            rec = {"schema": obs_ledger.OBS_SCHEMA,
                   "kind": obs_ledger.ROUND, "round": r}
            rec.update({k: v for k, v in row.items()
                        if k not in TIMING_FIELDS})
            sink.emit(rec)

    def _save_ckpt(self, ckpt_dir: str, round_: int, gp, state,
                   carry: dict, rows: list) -> None:
        from repro_torch import checkpoint

        trace = {k: np.stack([row[k] for row in rows]) for k in rows[0]}
        checkpoint.save_federation(
            ckpt_dir, round_, pytree.to_ref_tree(gp, self.model.layout),
            state, carry=carry, trace=trace,
            extra_meta={"engine": self.cfg.engine,
                        "method": self.cfg.method,
                        "rounds": self.cfg.rounds})

    def _restore_ckpt(self, ckpt_dir: str, like: dict, device):
        """Latest-checkpoint restore: ``(rounds done, θ params, strategy
        state, carry, trace rows)``, or None when the directory holds no
        checkpoint yet (a resume flag on a first run is a fresh start).

        θ comes back from the snapshot's reference-named ``global`` tree,
        the strategy state through a template of its structure (the state
        of a one-column W with the identity permutation: no draw), and the
        carry by its leaf names, each tensor in its recorded dtype on the
        run's device.
        """
        from repro_torch import checkpoint

        step = checkpoint.latest_step(ckpt_dir)
        if step is None:
            return None
        tree, meta = checkpoint.load(ckpt_dir, step, device=device)
        if meta.get("schema") != checkpoint.FEDERATION_SCHEMA:
            raise ValueError(
                f"{ckpt_dir} step {step} is not a federation checkpoint "
                f"(schema={meta.get('schema')!r})")
        if meta.get("engine") != self.cfg.engine:
            raise ValueError(
                f"checkpoint at {ckpt_dir} was written by engine "
                f"{meta.get('engine')!r}; cannot resume with "
                f"{self.cfg.engine!r}")
        if "carry" not in tree or "trace" not in tree:
            raise ValueError(
                f"checkpoint at {ckpt_dir} step {step} has no resume "
                f"payload (published snapshot instead of ckpt_every?)")
        gp = {k: v.to(like[k].dtype) for k, v in pytree.from_ref_tree(
            tree["global"], self.model.layout).items()}
        n = self.cfg.n_clients
        template = self.strategy.init_state(
            torch.zeros((n, 1), device=device),
            perm=torch.arange(n, device=device))
        state = checkpoint.from_indexed(tree["strategy"], template)
        trace = {k: v.cpu().numpy() for k, v in tree["trace"].items()}
        rows = [{k: v[i] for k, v in trace.items()}
                for i in range(step + 1)]
        return int(step), gp, state, tree["carry"], rows

    def run(self, init_params: dict[str, torch.Tensor],
            client_data: dict[str, torch.Tensor], *,
            generator: torch.Generator | None = None,
            draws: Draws | None = None,
            snapshot_every: int | None = None, store=None,
            ckpt_every: int | None = None, ckpt_dir: str | None = None,
            resume: bool = False,
            metrics_every: int | None = None,
            sink: obs_ledger.Sink | None = None) -> tuple[dict, History]:
        """Run the full federation; returns (final θ params, History).

        Args:
          init_params: θ^(0), on the device the run uses.
          client_data: dict of (S, n_local, ...) tensors on that device
            (S = n_clients shards; in cohort mode device i reads shard
            ``i % S``).
          generator: CPU ``torch.Generator`` the shuffles and the Step-I
            permutation are drawn from, and whose seed seeds the other
            streams (ignored for what ``draws`` injects).
          draws: injected randomness (:class:`Draws`).
          snapshot_every: publish a serving snapshot (θ + per-coalition
            barycenters + assignment) into ``store`` at every round
            ``r % snapshot_every == 0`` plus the final round.
          store: a :class:`repro_torch.serve.ModelStore` (required with
            ``snapshot_every``).
          ckpt_every: write a resumable ``save_federation`` checkpoint into
            ``ckpt_dir`` on the same cadence rule.
          ckpt_dir: checkpoint directory (required with ``ckpt_every`` or
            ``resume``; rejected without either).
          resume: restore the latest checkpoint under ``ckpt_dir`` and
            continue to the uninterrupted run's History (an empty directory
            is a fresh start).  The same ``generator`` seed (or ``draws``)
            must be given: the substrate and cohort draws are made again
            from it.
          metrics_every: stream a ``round`` record into ``sink`` every
            ``metrics_every`` rounds (plus round 0 and the final round).
            Requires ``sink``; a ``sink`` alone defaults to every round.
          sink: a :class:`repro_torch.obs.Sink`; the run opens with one
            ``run_meta`` record.  The caller owns the sink's lifetime.
        """
        if generator is None and draws is None:
            raise ValueError("run needs a generator or injected draws")
        if snapshot_every is not None:
            if snapshot_every < 1:
                raise ValueError(
                    f"snapshot_every={snapshot_every} must be >= 1")
            if store is None:
                raise ValueError("snapshot_every requires a store "
                                 "(repro_torch.serve.ModelStore)")
        elif store is not None:
            raise ValueError("store given without snapshot_every")
        if ckpt_every is not None:
            if ckpt_every < 1:
                raise ValueError(f"ckpt_every={ckpt_every} must be >= 1")
            if ckpt_dir is None:
                raise ValueError("ckpt_every requires ckpt_dir")
        elif ckpt_dir is not None and not resume:
            raise ValueError("ckpt_dir given without ckpt_every or resume "
                             "would never write a checkpoint")
        if resume and ckpt_dir is None:
            raise ValueError("resume requires ckpt_dir")
        if metrics_every is not None:
            if metrics_every < 1:
                raise ValueError(
                    f"metrics_every={metrics_every} must be >= 1")
            if sink is None:
                raise ValueError("metrics_every requires a sink "
                                 "(repro_torch.obs.make_sink)")
        elif sink is not None:
            metrics_every = 1                   # a sink alone: every round
        if self.rank != 0:
            sink = None                         # rank 0 writes the ledger
        cfg, strategy = self.cfg, self.strategy
        layout = self.model.layout
        device = next(iter(client_data.values())).device
        n_local = next(iter(client_data.values())).shape[1]
        steps = self._n_steps()
        model_bytes = pytree.tree_bytes(init_params)
        sub = self._substrate(steps, generator, draws, device, model_bytes)
        cohorts = self._cohort_schedule(steps, generator, draws, device)
        adv_fleet = None if self.adversaries is None else torch.tensor(
            self.adversaries, dtype=torch.float32, device=device)
        noise = {"dp": _Noise(None if draws is None else draws.dp_noise,
                              self._stream(DP_STREAM, generator, device)
                              if cfg.client.dp_sigma > 0.0 else None),
                 "attack": _Noise(
                     None if draws is None else draws.attack_noise,
                     self._stream(sim_mod.ATTACK_STREAM, generator, device)
                     if adv_fleet is not None else None)}
        gens = {"run": generator, **{k: nz.generator
                                     for k, nz in noise.items()}}
        gens = {k: g for k, g in gens.items() if g is not None}
        rows = []
        gp, state, prev_assign, prev_bary = init_params, None, None, None
        r_done = -1
        restored = (self._restore_ckpt(ckpt_dir, init_params, device)
                    if resume else None)
        if restored is not None:
            r_done, gp, state, carry, rows = restored
            prev_assign, prev_bary = carry["prev_assign"], carry["bary"]
            if self._tiled:
                from repro_torch.core import sharded

                prev_bary = sharded.column_tile(prev_bary, self.mesh)
            if sub is not None:
                sub.load(carry["sub"])
            for k, g in gens.items():
                g.set_state(carry["rng"][k].cpu())
        if sink is not None:
            sink.emit(self._run_meta_record(sub, model_bytes))
            # on resume the restored rows are re-emitted, so the ledger is
            # complete from round 0 whichever checkpoint the run resumed at
            self._emit_rows(sink, rows, 0, metrics_every, steps)
        for r in range(r_done + 1, steps + 1):
            t0 = time.perf_counter()
            ids = None if cohorts is None else cohorts[r]
            adv = adv_fleet if ids is None or adv_fleet is None \
                else adv_fleet[ids]
            with record_function("fl.shuffle"):
                perms = self._shuffles(r, n_local, device, generator, draws)
            w, losses = self._local_phase(r, gp, client_data, perms, ids,
                                          adv, noise)
            agg, eff, mask = w, None, None
            if sub is not None:
                agg, eff, mask = sub.step(r, w) if r else sub.census(w)
            _sync(device)
            t1 = time.perf_counter()
            with record_function("fl.server"):
                if r == 0:
                    state = strategy.init_state(
                        w, perm=None if draws is None else draws.center_perm,
                        generator=generator)
                res = strategy.round(agg, state, mask=eff)
                d = agg.shape[1]
                theta = self._whole(res.theta, d)
                _sync(device)
            t2 = time.perf_counter()
            state = res.state
            gp = pytree.unflatten(theta, layout, gp)
            bary = self._bary_of(res)           # this rank's tile on a mesh
            assignment = res.metrics.assignment
            loss = torch.mean(losses)
            if eff is not None:
                # participants' mean loss through the same mean (the scale
                # is exactly 1.0 at full participation)
                m = mask.float()
                scale = cfg.n_clients / torch.clamp(torch.sum(m), min=1.0)
                loss = torch.mean(losses * (m * scale))
            with record_function("fl.eval"):
                acc = self.eval_fn(gp)
            row = {"loss": loss, "acc": acc,
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
                row["drift"] = self._drift(bary, prev_bary)
            if sub is not None:
                row.update(sub.row(r, mask))
            if ids is not None:
                row["cohort"] = ids
            row.update(self._attack_row(res, adv))
            with record_function("fl.readback"):
                rows.append({k: v.detach().cpu().numpy()
                             if torch.is_tensor(v) else np.asarray(v)
                             for k, v in row.items()})
            if r == r_done + 1 and rows[0].keys() != rows[-1].keys():
                raise ValueError(
                    f"checkpoint trace metrics {sorted(rows[0])} do not "
                    f"match this run's {sorted(rows[-1])}")
            prev_assign, prev_bary = assignment, bary
            if sink is not None:
                self._emit_rows(sink, rows[-1:], r, metrics_every, steps)
            publish = self._fires(r, snapshot_every, steps)
            save = self._fires(r, ckpt_every, steps)
            if (publish or save) and self._tiled:
                bary = self._whole(bary, d)     # every rank joins the gather
            if publish and self.rank == 0:
                self._publish(store, r, gp, bary, rows[-1])
            if save and self.rank == 0:
                carry = {"bary": bary, "prev_assign": assignment,
                         "rng": {k: g.get_state() for k, g in gens.items()}}
                if sub is not None:
                    carry["sub"] = sub.carry()
                self._save_ckpt(ckpt_dir, r, gp, state, carry, rows)
        trace = Trace(**{f: np.stack([row[f] for row in rows])
                         for f in Trace._fields if f in rows[0]})
        return gp, History(trace=trace)


def run_federation(init_params: dict[str, torch.Tensor], model: FLModel,
                   eval_fn: Callable[[dict], torch.Tensor],
                   client_data: dict[str, torch.Tensor],
                   cfg: FederationConfig, *,
                   generator: torch.Generator | None = None,
                   draws: Draws | None = None,
                   strategy: Strategy | None = None) -> History:
    """Compatibility entry point: build a :class:`Federation` and run it
    (the reference's ``run_federation``, with the port's generator or
    injected draws in place of its key)."""
    _, hist = Federation(model, eval_fn, cfg, strategy=strategy).run(
        init_params, client_data, generator=generator, draws=draws)
    return hist
