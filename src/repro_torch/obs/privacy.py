"""Differential-privacy accounting for the DP client path (a pure-Python
copy of ``repro.obs.privacy``).

The DP client path (:func:`repro_torch.core.client.privatize`) is the
Gaussian mechanism per client per round: the update delta is clipped to L2
norm ``dp_clip`` and perturbed with ``N(0, (dp_sigma * dp_clip)^2 I)``.
Over ``rounds`` rounds the Renyi accountant (Abadi et al. 2016, Mironov
2017) gives

    eps(alpha) = rounds * q^2 * alpha / (2 * sigma^2)        (RDP order alpha)
    eps        = min_alpha [ eps(alpha) + log(1/delta) / (alpha - 1) ]

with ``q`` the per-round participation probability (1.0 under full
participation) and ``sigma = dp_sigma``.  It never touches the training
path.
"""
from __future__ import annotations

import math

import numpy as np

# RDP orders swept by the accountant: dense low orders (tight for large
# noise) plus a geometric tail (tight for many rounds / small noise).
_ORDERS = tuple(np.concatenate([
    np.arange(1.25, 20.0, 0.25),
    np.exp(np.linspace(math.log(20.0), math.log(4096.0), 40)),
]))


def gaussian_epsilon(sigma: float, rounds: int, *, delta: float = 1e-5,
                     q: float = 1.0) -> float:
    """(eps, delta)-DP epsilon of ``rounds`` subsampled Gaussian mechanisms.

    ``sigma`` is the noise multiplier (noise std / clip norm).  Returns
    ``inf`` when ``sigma == 0`` (no noise, no guarantee) and ``0.0`` when no
    rounds ran or no data participates (``q = 0``).
    """
    if sigma < 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q={q} must be in [0, 1]")
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta={delta} must be in (0, 1)")
    if rounds < 0:
        raise ValueError(f"rounds={rounds} must be >= 0")
    if rounds == 0 or q == 0.0:
        return 0.0
    if sigma == 0.0:
        return math.inf
    log_inv_delta = math.log(1.0 / delta)
    best = math.inf
    for alpha in _ORDERS:
        rdp = rounds * (q ** 2) * alpha / (2.0 * sigma ** 2)
        best = min(best, rdp + log_inv_delta / (alpha - 1.0))
    return float(best)
