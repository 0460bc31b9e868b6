"""Device fleets — per-device hardware/network tables and named profiles.

A :class:`DeviceFleet` describes an IoT client population: seconds per unit
of local work, uplink/downlink bytes per second, and per-round availability
with its burstiness.  Profiles are a registry mirroring the reference's
``repro.sim.devices``; the tables here are numpy float32 arrays.

Built-ins:

  ``ideal``           — full participation, zero latency: infinite links,
                        instant compute, p_available = 1.  The identity
                        profile: ``semi_async`` on it reproduces ``scan``
                        bit for bit.
  ``uniform``         — speeds and link rates uniform over a moderate
                        range, every device always reachable (stragglers
                        only through a deadline).
  ``lognormal-edge``  — log-normal compute and bandwidth tails, downlink
                        4x the uplink, availability 0.85-1.0, persistence
                        0.3.
  ``cellular-flaky``  — thin heavy-tailed uplinks, downlink 8x the uplink,
                        availability 0.4-0.9, persistence 0.5 (bursty
                        multi-round outages).

The sampled profiles have the reference's distributions but draw from a CPU
``torch.Generator`` seeded with ``seed`` (torch cannot reproduce threefry),
so ``make_fleet("cellular-flaky", n, seed=0)`` is not the reference's table
for the same seed.  Parity tests carry the reference's table over with
:func:`repro_torch.carry.fleet_from_jax`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class SimConfig(NamedTuple):
    """Substrate knobs the federation engine consumes.

    ``fleet``           — registered fleet-profile name.
    ``participation``   — global scale on per-device availability (0..1).
    ``staleness_alpha`` — exponent of the staleness decay ``(1 + tau)^-alpha``
                          (``tau`` in rounds).
    ``deadline``        — round deadline in simulated seconds; a device whose
                          download + compute + upload exceeds it misses the
                          round.
    ``local_work``      — simulated compute units one local round costs
                          (scales ``DeviceFleet.compute_s``).
    ``energy_budget``   — per-device energy budget in joules of the
                          ``event_driven`` engine: every train-and-report
                          cycle costs ``device_event_energy`` and a device
                          that can no longer afford one retires (inf =
                          unconstrained).
    ``max_events``      — events after the census of the ``event_driven``
                          engine; None = ``rounds - 1``.
    ``seed``            — fleet-sampling seed.
    ``scenario``        — registered fleet+data scenario name (validated by
                          the engine, recorded for provenance).
    ``rho``             — fleet-data coupling strength in [0, 1].

    ``staleness_alpha`` decays ``tau`` in rounds under ``semi_async`` and in
    simulated seconds under ``event_driven``; ``deadline`` serves
    ``semi_async`` only.
    """

    fleet: str = "ideal"
    participation: float = 1.0
    staleness_alpha: float = 0.5
    deadline: float = float("inf")
    local_work: float = 1.0
    energy_budget: float = float("inf")
    max_events: int | None = None
    seed: int = 0
    scenario: str = "independent"
    rho: float = 0.0


class DeviceFleet(NamedTuple):
    """Static per-device table; every field is an ``(n_clients,)`` float32."""

    compute_s: np.ndarray     # seconds per unit of local work
    uplink_bps: np.ndarray    # uplink bytes/second
    downlink_bps: np.ndarray  # downlink bytes/second
    p_available: np.ndarray   # stationary per-round availability probability
    persistence: np.ndarray   # P(availability state persists round->round)


_FLEETS: dict[str, Callable[[int, int], DeviceFleet]] = {}


def register_fleet(name: str) -> Callable:
    """Decorator: register a fleet-profile factory ``(seed, n) -> fleet``."""

    def deco(factory: Callable[[int, int], DeviceFleet]):
        _FLEETS[name] = factory
        return factory

    return deco


def make_fleet(name: str, n_clients: int, *, seed: int = 0) -> DeviceFleet:
    """The device table for profile ``name`` (deterministic in seed)."""
    try:
        factory = _FLEETS[name]
    except KeyError:
        raise ValueError(
            f"unknown fleet profile {name!r}; available: {available_fleets()}"
        ) from None
    if n_clients < 1:
        raise ValueError(f"n_clients={n_clients} must be >= 1")
    return factory(seed, n_clients)


def available_fleets() -> tuple[str, ...]:
    return tuple(sorted(_FLEETS))


def _full(n: int, v: float) -> np.ndarray:
    return np.full((n,), v, np.float32)


def _uniform_draw(g: torch.Generator, n: int, lo: float,
                  hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand((n,), generator=g)


def _lognormal(g: torch.Generator, n: int, median: float,
               sigma: float) -> torch.Tensor:
    """Log-normal samples with the given median and log-space sigma."""
    return median * torch.exp(sigma * torch.randn((n,), generator=g))


def _table(**cols) -> DeviceFleet:
    return DeviceFleet(**{k: np.asarray(v, np.float32)
                          for k, v in cols.items()})


@register_fleet("ideal")
def _ideal(seed: int, n: int) -> DeviceFleet:
    return DeviceFleet(compute_s=_full(n, 0.0), uplink_bps=_full(n, np.inf),
                       downlink_bps=_full(n, np.inf),
                       p_available=_full(n, 1.0), persistence=_full(n, 0.0))


@register_fleet("uniform")
def _uniform(seed: int, n: int) -> DeviceFleet:
    g = torch.Generator().manual_seed(seed)
    return _table(compute_s=_uniform_draw(g, n, 0.5, 2.0),
                  uplink_bps=_uniform_draw(g, n, 1e6, 10e6),   # 1-10 MB/s
                  downlink_bps=_uniform_draw(g, n, 5e6, 20e6),
                  p_available=_full(n, 1.0), persistence=_full(n, 0.0))


@register_fleet("lognormal-edge")
def _lognormal_edge(seed: int, n: int) -> DeviceFleet:
    g = torch.Generator().manual_seed(seed)
    compute = _lognormal(g, n, 1.0, 0.75)
    up = _lognormal(g, n, 2e6, 0.8)
    return _table(compute_s=compute, uplink_bps=up,
                  downlink_bps=4.0 * up,       # asymmetric last-mile links
                  p_available=_uniform_draw(g, n, 0.85, 1.0),
                  persistence=_full(n, 0.3))


@register_fleet("cellular-flaky")
def _cellular_flaky(seed: int, n: int) -> DeviceFleet:
    g = torch.Generator().manual_seed(seed)
    compute = _lognormal(g, n, 1.5, 1.0)
    up = _lognormal(g, n, 2.5e5, 1.25)   # thin, heavy-tailed cellular uplink
    return _table(compute_s=compute, uplink_bps=up, downlink_bps=8.0 * up,
                  p_available=_uniform_draw(g, n, 0.4, 0.9),
                  persistence=_full(n, 0.5))   # bursty multi-round outages
