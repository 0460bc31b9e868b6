"""Device fleets — per-device hardware/network tables and named profiles.

A :class:`DeviceFleet` describes an IoT client population: seconds per unit
of local work, uplink/downlink bytes per second, and per-round availability
with its burstiness.  Profiles are a registry mirroring the reference's
``repro.sim.devices``; the tables here are numpy float32 arrays.

Ported so far: ``ideal`` — full participation, zero latency (infinite links,
instant compute, p_available = 1), the profile of the main training path.
The sampled profiles (``uniform``, ``lognormal-edge``, ``cellular-flaky``)
draw from JAX's threefry stream in the reference and wait for the
simulation slice (ROADMAP queue A item 8).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np


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


@register_fleet("ideal")
def _ideal(seed: int, n: int) -> DeviceFleet:
    return DeviceFleet(compute_s=_full(n, 0.0), uplink_bps=_full(n, np.inf),
                       downlink_bps=_full(n, np.inf),
                       p_available=_full(n, 1.0), persistence=_full(n, 0.0))
