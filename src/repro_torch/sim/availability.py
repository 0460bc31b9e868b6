"""Per-round device availability — a two-state Markov process (mirrors
``repro.sim.availability``).

Each device is *online* or *offline*; every round its state persists with
probability ``fleet.persistence`` and is otherwise resampled as
Bernoulli(p_eff), where ``p_eff = clip(p_available * participation, 0, 1)``.
``persistence = 0`` is i.i.d. participation; near 1 it gives the long bursty
outages of cellular fleets.  The stationary marginal stays ``p_eff``.

Randomness is injected, as everywhere in the port: the census ``online``
draw and each round's ``stay``/``fresh`` draws are (N,) booleans.  The
reference draws them from ``fold_in(key, AVAILABILITY_STREAM)``; the port
draws them in bulk with :func:`draw_availability` from a CPU
``torch.Generator`` of their own, so the client-update draws are untouched
(which keeps ``semi_async`` equal to ``scan`` on the ideal fleet), and the
parity tests pass the reference's.  Every tensor function here runs on the
device of its inputs and never reads a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.sim.devices import DeviceFleet

#: the reference's fold_in tag of the availability stream; the port offsets
#: its availability generator's seed by it
AVAILABILITY_STREAM = 0x10A7


class AvailabilityState(NamedTuple):
    """Round-carried availability bookkeeping."""

    online: torch.Tensor   # (N,) bool — current Markov state


class AvailabilityDraws(NamedTuple):
    """A run's availability draws: the census state and, per later round,
    which devices keep their state and the fresh state of the others."""

    online: np.ndarray     # (N,) bool
    stay: np.ndarray       # (R-1, N) bool
    fresh: np.ndarray      # (R-1, N) bool


def _col(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def effective_p(fleet: DeviceFleet, participation: float = 1.0
                ) -> torch.Tensor:
    """Per-device round-availability probability after the global scale."""
    return torch.clamp(_col(fleet.p_available) * float(participation),
                       0.0, 1.0)


def draw_availability(fleet: DeviceFleet, participation: float, rounds: int,
                      generator: torch.Generator) -> AvailabilityDraws:
    """Every availability draw of an R-round run, from ``generator``: the
    census state in the stationary distribution, then each later round's
    ``stay`` ~ Bernoulli(persistence) and ``fresh`` ~ Bernoulli(p_eff)."""
    p = effective_p(fleet, participation)
    persist = _col(fleet.persistence)
    n = p.shape[0]
    online = torch.rand((n,), generator=generator) < p
    stay = np.zeros((max(rounds - 1, 0), n), bool)
    fresh = np.zeros_like(stay)
    for r in range(rounds - 1):
        stay[r] = (torch.rand((n,), generator=generator) < persist).numpy()
        fresh[r] = (torch.rand((n,), generator=generator) < p).numpy()
    return AvailabilityDraws(online=online.numpy(), stay=stay, fresh=fresh)


def init_availability(online, device=None) -> AvailabilityState:
    """The process's census state from its (N,) boolean draw."""
    return AvailabilityState(
        online=torch.tensor(np.asarray(online), dtype=torch.bool,
                            device=device))


def sample_mask(state: AvailabilityState, stay: torch.Tensor,
                fresh: torch.Tensor, device_time: torch.Tensor | None = None,
                deadline: float = float("inf"),
                ) -> tuple[torch.Tensor, AvailabilityState]:
    """Advance one round; returns ``((N,) bool participation mask, state')``.

    A device participates iff its Markov state is online AND (when
    ``device_time`` is given) it finishes download + compute + upload
    within ``deadline`` simulated seconds: the deadline is how slow devices
    become stragglers.
    """
    online = torch.where(stay, state.online, fresh)
    mask = online
    if device_time is not None:
        mask = mask & (device_time <= float(deadline))
    return mask, AvailabilityState(online=online)
