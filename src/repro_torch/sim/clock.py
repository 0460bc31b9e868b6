"""Simulated wall-clock, staleness decay, energy and bytes-on-the-wire
accounting (mirrors ``repro.sim.clock``).

Every round the ``semi_async`` engine records how long it took on the
simulated fleet and how many bytes crossed the WAN and the edge links.  All
functions are elementwise algebra on the device of their inputs, in f32 as
the reference computes them; a fleet's numpy columns are carried there.
"""
from __future__ import annotations

import math

import torch

from repro_torch.sim.devices import DeviceFleet


def _col(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def staleness_weights(tau: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """Polynomial staleness decay ``(1 + tau)^-alpha`` (FedAsync family).

    ``tau`` is the per-client age of the buffered update in rounds; ``tau =
    0`` maps to exactly 1.0 (so fresh updates are bit-identically
    unweighted, whichever pow the device takes for the exponent), and
    ``alpha = 0`` disables the decay.
    """
    t = tau.float()
    return torch.where(t == 0, torch.ones_like(t), (1.0 + t) ** (-alpha))


def device_round_time(fleet: DeviceFleet, model_bytes: float,
                      local_work: float = 1.0, device=None) -> torch.Tensor:
    """(N,) seconds of one round on each device: download θ + ``local_work``
    units of compute + upload ω.  The ideal fleet (infinite links, zero
    compute) gives exactly 0.0."""
    down = _col(fleet.downlink_bps, device)
    b = torch.full_like(down, float(model_bytes))
    return (b / down + float(local_work) * _col(fleet.compute_s, device)
            + b / _col(fleet.uplink_bps, device))


def device_event_energy(fleet: DeviceFleet, model_bytes: float,
                        local_work: float = 1.0, *,
                        compute_power_w: float = 1.0,
                        tx_power_w: float = 1.0,
                        rx_power_w: float = 0.5) -> torch.Tensor:
    """(N,) joules one train-and-report cycle costs on each device: receive
    θ at ``rx_power_w``, compute ``local_work`` units at
    ``compute_power_w``, transmit ω at ``tx_power_w``, along the critical
    path of :func:`device_round_time`.  The ideal fleet costs exactly 0.0.
    """
    down = _col(fleet.downlink_bps)
    b = torch.full_like(down, float(model_bytes))
    work = torch.full_like(down, float(compute_power_w)) * float(local_work)
    return (float(rx_power_w) * b / down + work * _col(fleet.compute_s)
            + float(tx_power_w) * b / _col(fleet.uplink_bps))


def round_stats(mask: torch.Tensor, device_time: torch.Tensor,
                model_bytes: float, n_groups: int, hierarchical: bool,
                deadline: float = float("inf"),
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-round ``(sim_time_s, wan_bytes, edge_bytes)``.

    Under a finite ``deadline`` the server closes a round early only when
    every device has reported (it cannot tell an offline device from a late
    one), so a round with absentees costs the full deadline.  With an
    infinite deadline the round closes at its slowest participant (0.0 when
    empty).  Flat rules ship every participant's model over the WAN both
    ways; hierarchical (coalition) rules ship participants to their heads
    over the edge and ``min(K, n_present)`` barycenter-sized models over
    the WAN.
    """
    m = mask.float()
    n_present = torch.sum(m)
    sim_time = torch.max(torch.where(mask, device_time,
                                     torch.zeros_like(device_time)))
    if math.isfinite(deadline):
        # a Python branch: the infinite-deadline path stays as it was
        sim_time = torch.where(n_present >= mask.shape[0], sim_time,
                               torch.full_like(sim_time, float(deadline)))
    traffic = torch.full_like(n_present, 2.0 * float(model_bytes))
    if hierarchical:
        wan = torch.clamp(n_present, max=float(n_groups)) * traffic
        edge = n_present * traffic
    else:
        wan = n_present * traffic
        edge = torch.zeros_like(n_present)
    return sim_time, wan, edge
