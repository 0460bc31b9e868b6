"""Byzantine attack registry — client-update corruption (mirrors
``repro.sim.attacks``).

Do Euclidean-distance coalitions quarantine byzantine clients, or do the
attackers poison honest barycenters?  An :class:`Attack` corrupts a masked
subset of clients through two hooks that every engine and strategy
composes with unchanged:

  ``poison(data, adversary)``
      Data poisoning of the (gathered) client batch dict before local
      training; ``adversary`` is the (N,) float32 0/1 mask of the rows.
  ``transform(w, theta, adversary, normal)``
      Model poisoning of the (N, D) client matrix after local training (and
      after the DP path), before aggregation; ``theta`` is the (D,) global
      model the round started from; ``normal()`` returns standard normal
      noise shaped like ``w`` (the engine injects the reference's draws or
      draws from a generator of its own).

Both hooks gate through ``torch.where(adversary > 0, attacked, clean)``, so
each is the exact identity where the mask is 0, and an attack at
``adv_frac = 0`` gives the clean run bit for bit.

Built-ins: ``label_flip`` (integer labels ``n_classes - 1 - y``, float
targets ``-y``), ``scale_update`` (``theta + boost * (w - theta)``),
``sign_flip`` (``2 * theta - w``, as ``theta + (theta - w)``) and
``gaussian_noise`` (``w + sigma * N(0, I)``).

:func:`adversary_mask` places the attackers with numpy's ``default_rng``
and the scenarios' rank machinery, so on the same device table it equals
the reference's bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.sim.devices import DeviceFleet
from repro_torch.sim.scenarios import _ranks, capability_rank

#: the reference's fold_in tag of the attack noise; the port offsets its
#: attack-noise generator's seed by it
ATTACK_STREAM = 0xA77C


class Attack(NamedTuple):
    """One registered attack model: a (poison, transform) hook pair."""

    name: str
    poison: Callable[[dict, torch.Tensor], dict]
    transform: Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                         Callable[[], torch.Tensor]], torch.Tensor]
    params: dict


_ATTACKS: dict[str, Callable[..., Attack]] = {}


def register_attack(name: str) -> Callable:
    """Decorator: register an attack factory (keyword hyper-parameters ->
    :class:`Attack`) under ``name``."""

    def deco(factory: Callable[..., Attack]) -> Callable[..., Attack]:
        _ATTACKS[name] = factory
        return factory

    return deco


def available_attacks() -> tuple[str, ...]:
    return tuple(sorted(_ATTACKS))


def make_attack(name: str, **kw) -> Attack:
    """Instantiate attack ``name`` with hyper-parameters ``kw``."""
    try:
        factory = _ATTACKS[name]
    except KeyError:
        raise ValueError(
            f"unknown attack {name!r}; available: {available_attacks()}"
        ) from None
    return factory(**kw)


# --- adversary placement ----------------------------------------------------------

def adversary_mask(fleet: DeviceFleet, adv_frac: float,
                   rho_adv: float = 0.0, *, seed: int = 0) -> np.ndarray:
    """(N,) boolean adversary mask with rank-coupled placement.

    ``round(adv_frac * N)`` devices are compromised.  ``rho_adv`` blends a
    seeded random placement (0) with rank matching: +1 compromises the
    strongest devices (composite capability rank), -1 the weakest.
    Deterministic in ``(fleet, adv_frac, rho_adv, seed)``.
    """
    n = len(np.asarray(fleet.compute_s))
    if not 0.0 <= adv_frac < 1.0:
        raise ValueError(f"adv_frac={adv_frac} must be in [0, 1)")
    if not -1.0 <= rho_adv <= 1.0:
        raise ValueError(f"rho_adv={rho_adv} must be in [-1, 1]")
    n_adv = int(round(adv_frac * n))
    mask = np.zeros(n, dtype=bool)
    if n_adv == 0:
        return mask
    rng = np.random.default_rng(np.uint32(seed) ^ np.uint32(ATTACK_STREAM))
    rand_rank = _ranks(rng.permutation(n).astype(np.float64))
    cap = capability_rank(fleet)
    target = cap if rho_adv >= 0.0 else (n - 1) - cap
    score = (1.0 - abs(rho_adv)) * rand_rank + abs(rho_adv) * target
    # highest blended score = compromised; the stable sort breaks ties
    # toward the lower device index
    order = np.argsort(-score, kind="stable")
    mask[order[:n_adv]] = True
    return mask


# --- built-in attacks -------------------------------------------------------------

def _rows(adversary: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """The (N,) mask as a boolean broadcast over a client-major leaf."""
    return (adversary > 0).reshape((-1,) + (1,) * (leaf.dim() - 1))


def _poison_identity(data: dict, adversary: torch.Tensor) -> dict:
    return data


def _flip_labels(data: dict, adversary: torch.Tensor,
                 n_classes: int) -> dict:
    """Flip the ``y`` leaf of a client-major batch dict for adversaries:
    integer labels map to ``n_classes - 1 - y``, float targets negate."""
    y = data["y"]
    if y.is_floating_point():
        flipped = -y
    else:
        flipped = (n_classes - 1 - y).to(y.dtype)
    return dict(data, y=torch.where(_rows(adversary, y), flipped, y))


@register_attack("label_flip")
def _label_flip(*, n_classes: int = 10) -> Attack:
    return Attack(
        name="label_flip",
        poison=lambda data, adv: _flip_labels(data, adv, n_classes),
        transform=lambda w, theta, adv, normal: w,
        params={"n_classes": n_classes},
    )


@register_attack("scale_update")
def _scale_update(*, boost: float = 10.0) -> Attack:
    if boost <= 0.0 or not math.isfinite(boost):
        raise ValueError(f"boost={boost} must be finite and > 0")

    def transform(w, theta, adv, normal):
        t = theta.to(w.dtype)[None, :]
        boosted = t + torch.tensor(boost, dtype=w.dtype,
                                   device=w.device) * (w - t)
        return torch.where(_rows(adv, w), boosted, w)

    return Attack(name="scale_update", poison=_poison_identity,
                  transform=transform, params={"boost": boost})


@register_attack("sign_flip")
def _sign_flip() -> Attack:
    def transform(w, theta, adv, normal):
        t = theta.to(w.dtype)[None, :]
        return torch.where(_rows(adv, w), t + (t - w), w)

    return Attack(name="sign_flip", poison=_poison_identity,
                  transform=transform, params={})


@register_attack("gaussian_noise")
def _gaussian_noise(*, sigma: float = 1.0) -> Attack:
    if sigma < 0.0 or not math.isfinite(sigma):
        raise ValueError(f"sigma={sigma} must be finite and >= 0")

    def transform(w, theta, adv, normal):
        noise = torch.tensor(sigma, dtype=w.dtype, device=w.device) * \
            normal().to(w.dtype)
        return torch.where(_rows(adv, w), w + noise, w)

    return Attack(name="gaussian_noise", poison=_poison_identity,
                  transform=transform, params={"sigma": sigma})

