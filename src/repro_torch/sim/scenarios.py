"""Fleet-aware data scenarios — joint sampling of the device fleet and the
data partition (numpy; mirrors ``repro.sim.scenarios``).

A *scenario* produces ``(DeviceFleet, index_matrix, metadata)`` from one
seed, with a coupling knob ``rho`` between device capability rank and shard
rank.  Coupling only permutes which device holds which shard.

Built-ins:

  ``independent``          — the decoupled sampling (``rho`` must be 0).
  ``correlated-skew``      — shard rank = negative label entropy: at
                             ``rho = 1`` the weakest device holds the most
                             label-skewed shard.
  ``correlated-quantity``  — shard rank = fewest unique samples (pair with
                             the ``quantity`` regime).

Everything here is numpy and deterministic.  Given the same device table,
the permutation, index matrix and ``spearman`` equal the reference's
exactly.  The port samples its fleets from its own generator
(:mod:`repro_torch.sim.devices`), so on a sampled profile the capability
ranks, and with them the permutation, follow the port's table, not the
reference's for the same ``sim_seed``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from repro_torch.data.loader import label_histogram
from repro_torch.data.partition import partition
from repro_torch.sim.devices import DeviceFleet, make_fleet


class Scenario(NamedTuple):
    """One jointly sampled evaluation scenario."""

    fleet: DeviceFleet        # the device table the engines will simulate
    index_matrix: np.ndarray  # (n_clients, n_local) per-device data shard
    metadata: dict            # permutation, ranks, achieved correlation, ...


_SCENARIOS: dict[str, Callable[..., Scenario]] = {}


def register_scenario(name: str) -> Callable:
    """Decorator: register a scenario factory under ``name``.

    The factory receives ``(labels, n_clients)`` positionally plus the
    keyword config ``fleet`` (profile name), ``regime`` (partition regime),
    ``rho``, ``seed``, ``sim_seed``, and any partitioner extras, and returns
    a :class:`Scenario`; it must be a pure function of its arguments.
    """

    def deco(factory: Callable[..., Scenario]) -> Callable[..., Scenario]:
        _SCENARIOS[name] = factory
        return factory

    return deco


def available_scenarios() -> tuple[str, ...]:
    return tuple(sorted(_SCENARIOS))


def make_scenario(name: str, labels: np.ndarray, n_clients: int, *,
                  fleet: str = "ideal", regime: str = "iid",
                  rho: float = 0.0, seed: int = 0,
                  sim_seed: int | None = None, **kw) -> Scenario:
    """Jointly sample fleet + partition for scenario ``name``.

    ``seed`` drives the partition; ``sim_seed`` drives the fleet table and
    defaults to ``seed`` so a scenario is reproducible from one integer.
    ``kw`` forwards to the partitioner (``alpha``, ``shards_per_client``,
    ``beta``).
    """
    try:
        factory = _SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; available: {available_scenarios()}"
        ) from None
    if not 0.0 <= rho <= 1.0:
        raise ValueError(f"rho={rho} must be in [0, 1]")
    if sim_seed is None:
        sim_seed = seed
    return factory(np.asarray(labels), n_clients, fleet=fleet, regime=regime,
                   rho=float(rho), seed=seed, sim_seed=sim_seed, **kw)


# --- rank machinery ---------------------------------------------------------------

def _ranks(v: np.ndarray) -> np.ndarray:
    """Dense 0..n-1 ascending ranks with stable (first-wins) tie-breaking."""
    order = np.argsort(np.asarray(v), kind="stable")
    r = np.empty(len(order), np.int64)
    r[order] = np.arange(len(order))
    return r


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation (Pearson over dense ranks)."""
    ra = _ranks(a).astype(np.float64)
    rb = _ranks(b).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = float(np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))
    return float((ra * rb).sum() / denom) if denom else 0.0


def capability_rank(fleet: DeviceFleet) -> np.ndarray:
    """(N,) device capability ranks: 0 = weakest, N-1 = strongest.

    A composite rank over exactly the per-device quantities the engines
    censor on — availability (the ``semi_async`` participation mask), compute
    speed and link rates (the deadline and the energy cost of a
    train-and-report cycle both follow the same
    download + compute + upload critical path).
    """
    composite = (_ranks(np.asarray(fleet.p_available, np.float64))
                 + _ranks(-np.asarray(fleet.compute_s, np.float64))
                 + _ranks(np.asarray(fleet.uplink_bps, np.float64))
                 + _ranks(np.asarray(fleet.downlink_bps, np.float64)))
    return _ranks(composite)


def label_skew_rank(labels: np.ndarray,
                    index_matrix: np.ndarray) -> np.ndarray:
    """(N,) shard label-skew ranks: 0 = most balanced, N-1 = most skewed.

    Skew = negative label entropy of the shard's label histogram — a
    single-class shard ranks highest, a uniform shard lowest.
    """
    n_classes = int(np.max(labels)) + 1
    hist = label_histogram(labels, index_matrix, n_classes=n_classes)
    p = hist / np.maximum(hist.sum(axis=1, keepdims=True), 1)
    ent = -np.sum(p * np.log(p, out=np.zeros_like(p, np.float64),
                             where=p > 0), axis=1)
    return _ranks(-ent)


def quantity_rank(index_matrix: np.ndarray) -> np.ndarray:
    """(N,) shard data-poverty ranks: 0 = most unique samples, N-1 = fewest.

    The ``quantity`` regime pads data-poor clients by resampling, so the
    unique-index count of a row is its effective dataset size.
    """
    uniq = np.array([len(np.unique(row)) for row in index_matrix])
    return _ranks(-uniq)


def couple(cap_rank: np.ndarray, shard_rank: np.ndarray,
           rho: float) -> np.ndarray:
    """Shard→device permutation interpolating identity (rho=0) and full
    rank matching (rho=1: weakest device ← highest-ranked shard).

    Returns ``perm`` with device ``i`` receiving shard ``perm[i]``.  Each
    shard's destination blends linearly between its current device and its
    rank-matched device; re-sorting the blended destinations always yields a
    valid permutation, monotone in ``rho``, with ties resolved toward the
    identity (stable sort).
    """
    n = len(cap_rank)
    # at rho=1, shard j goes to the device whose capability rank mirrors the
    # shard's rank: cap_rank == n-1-shard_rank[j] (weakest ← most skewed)
    device_of_cap = np.argsort(cap_rank, kind="stable")   # cap rank r -> device
    target = device_of_cap[(n - 1) - shard_rank]          # shard j -> device
    blended = (1.0 - rho) * np.arange(n) + rho * target
    return np.argsort(blended, kind="stable")


def _coupled(labels, n_clients, *, fleet, regime, rho, seed, sim_seed,
             shard_rank_fn, name, **kw) -> Scenario:
    """Shared body of the coupled scenarios: sample independently, then
    rank-permute which device holds which shard."""
    flt = make_fleet(fleet, n_clients, seed=sim_seed)
    idx = partition(regime, labels, n_clients, seed=seed, **kw)
    cap = capability_rank(flt)
    shard = shard_rank_fn(idx)
    perm = couple(cap, shard, rho)
    weakness = (n_clients - 1) - cap
    meta = {
        "scenario": name, "rho": rho, "fleet": fleet, "regime": regime,
        "seed": seed, "sim_seed": sim_seed,
        "permutation": perm.tolist(),
        "capability_rank": cap.tolist(),
        "shard_rank": shard.tolist(),
        # achieved rank correlation between device weakness and the rank of
        # the shard it ended up holding (1.0 at rho=1 modulo ties)
        "spearman": spearman(weakness, shard[perm]),
    }
    return Scenario(fleet=flt, index_matrix=idx[perm], metadata=meta)


# --- built-in scenarios -----------------------------------------------------------

@register_scenario("independent")
def _independent(labels, n_clients, *, fleet, regime, rho, seed, sim_seed,
                 **kw) -> Scenario:
    """Decoupled sampling: the fleet and the partition, each from its seed."""
    if rho != 0.0:
        raise ValueError(
            f"scenario 'independent' has no coupling to tune; rho={rho} "
            f"must be 0 (use 'correlated-skew' or 'correlated-quantity')")
    return _coupled(labels, n_clients, fleet=fleet, regime=regime, rho=0.0,
                    seed=seed, sim_seed=sim_seed,
                    shard_rank_fn=lambda idx: label_skew_rank(labels, idx),
                    name="independent", **kw)



@register_scenario("correlated-skew")
def _correlated_skew(labels, n_clients, *, fleet, regime, rho, seed,
                     sim_seed, **kw) -> Scenario:
    """Label-skew coupling: weak devices hold the most label-skewed shards."""
    return _coupled(labels, n_clients, fleet=fleet, regime=regime, rho=rho,
                    seed=seed, sim_seed=sim_seed,
                    shard_rank_fn=lambda idx: label_skew_rank(labels, idx),
                    name="correlated-skew", **kw)


@register_scenario("correlated-quantity")
def _correlated_quantity(labels, n_clients, *, fleet, regime, rho, seed,
                         sim_seed, **kw) -> Scenario:
    """Quantity coupling: weak devices hold the data-poorest shards."""
    return _coupled(labels, n_clients, fleet=fleet, regime=regime, rho=rho,
                    seed=seed, sim_seed=sim_seed,
                    shard_rank_fn=quantity_rank,
                    name="correlated-quantity", **kw)
