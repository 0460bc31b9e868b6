"""Federated data partitioners (numpy; a copy of ``repro.data.partition``) —
the paper's three regimes (§IV.A/B) plus a quantity-skew variant, behind a
registry.

  ``iid``       — each client gets an equal, class-balanced shard
                  (paper: 600 samples/class/client).
  ``dirichlet`` — label proportions per client ~ Dir(alpha); the paper's
                  "heterogeneous" regime (moderate alpha).
  ``shard``     — sort-by-label pathological split, ``shards_per_client``
                  classes each; the paper's "highly heterogeneous" regime.
  ``quantity``  — label-balanced draw but client *unique*-sample counts
                  ~ Dir(beta): data-poor clients are padded back to the
                  common shard size by resampling their own pool, so the
                  equal-shape contract holds while effective dataset sizes
                  differ (the quantity-skew axis of Li et al.'s splitter
                  taxonomy).

Partitioners are a registry, mirroring the strategy/backend/fleet
registries::

    @register_partitioner("my-split")
    def _split(labels, n_clients, seed=0, **kw) -> np.ndarray: ...

    idx = partition("my-split", labels, n_clients, seed=0)

All partitioners return an ``(n_clients, n_local)`` index matrix with equal
shard sizes (required for the vmapped ClientUpdate), trimming the remainder.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


def _equalize(parts: list[np.ndarray], n_local: int, rng) -> np.ndarray:
    """Trim/pad each client's index list to exactly n_local indices."""
    out = []
    for idx in parts:
        if len(idx) >= n_local:
            out.append(idx[:n_local])
        else:  # pad by resampling (rare; only under extreme Dirichlet draws)
            pad = rng.choice(idx, size=n_local - len(idx), replace=True)
            out.append(np.concatenate([idx, pad]))
    return np.stack(out)


_PARTITIONERS: dict[str, Callable[..., np.ndarray]] = {}

#: the reference's alias of the registry, for call sites that index it
REGIMES = _PARTITIONERS


def register_partitioner(name: str) -> Callable:
    """Decorator: register a partitioner under ``name``.

    The partitioner receives ``(labels, n_clients, seed=..., **kw)`` and
    returns an ``(n_clients, n_local)`` integer index matrix; it must be a
    pure function of its arguments so splits are reproducible.
    """

    def deco(fn: Callable[..., np.ndarray]) -> Callable[..., np.ndarray]:
        _PARTITIONERS[name] = fn
        return fn

    return deco


def available_regimes() -> tuple[str, ...]:
    return tuple(sorted(_PARTITIONERS))


@register_partitioner("iid")
def iid(labels: np.ndarray, n_clients: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_local = len(labels) // n_clients
    classes = np.unique(labels)
    per_class = n_local // len(classes)
    parts = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        for i in range(n_clients):
            parts[i].append(idx[i * per_class:(i + 1) * per_class])
    parts = [np.concatenate(p) for p in parts]
    for p in parts:
        rng.shuffle(p)
    return _equalize(parts, per_class * len(classes), rng)


@register_partitioner("dirichlet")
def dirichlet(labels: np.ndarray, n_clients: int, alpha: float = 0.5,
              seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_local = len(labels) // n_clients
    classes = np.unique(labels)
    class_idx = {c: rng.permutation(np.flatnonzero(labels == c)) for c in classes}
    # per-client class proportions
    props = rng.dirichlet(alpha * np.ones(len(classes)), size=n_clients)
    parts = []
    cursor = {c: 0 for c in classes}
    for i in range(n_clients):
        want = np.floor(props[i] * n_local).astype(int)
        want[np.argmax(want)] += n_local - want.sum()
        take = []
        for ci, c in enumerate(classes):
            pool = class_idx[c]
            k = want[ci]
            start = cursor[c]
            got = pool[start:start + k]
            cursor[c] = start + len(got)
            if len(got) < k:  # class exhausted: wrap around
                extra = pool[rng.integers(0, len(pool), size=k - len(got))]
                got = np.concatenate([got, extra])
            take.append(got)
        idx = np.concatenate(take)
        rng.shuffle(idx)
        parts.append(idx)
    return _equalize(parts, n_local, rng)


@register_partitioner("shard")
def shards(labels: np.ndarray, n_clients: int, shards_per_client: int = 2,
           seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_local = len(labels) // n_clients
    order = np.argsort(labels, kind="stable")
    n_shards = n_clients * shards_per_client
    shard_size = len(labels) // n_shards
    shard_ids = rng.permutation(n_shards)
    parts = []
    for i in range(n_clients):
        mine = shard_ids[i * shards_per_client:(i + 1) * shards_per_client]
        idx = np.concatenate([order[s * shard_size:(s + 1) * shard_size] for s in mine])
        rng.shuffle(idx)
        parts.append(idx)
    return _equalize(parts, min(n_local, shards_per_client * shard_size), rng)


@register_partitioner("quantity")
def quantity(labels: np.ndarray, n_clients: int, beta: float = 0.5,
             seed: int = 0) -> np.ndarray:
    """Quantity skew: per-client *unique*-sample counts ~ Dir(beta).

    Each client draws ``counts[i]`` unique indices from a label-shuffled
    pool (so the label marginal stays roughly balanced) and is then padded
    back to the common ``n_local`` by resampling its own pool via
    :func:`_equalize`.  Data-poor clients therefore train on many duplicate
    samples — effectively a smaller dataset — without breaking the equal
    ``(n_clients, n_local)`` shape the vmapped ClientUpdate requires.
    Smaller ``beta`` = heavier skew.
    """
    rng = np.random.default_rng(seed)
    n_local = len(labels) // n_clients
    props = rng.dirichlet(beta * np.ones(n_clients))
    counts = np.clip(np.floor(props * n_local * n_clients).astype(int),
                     1, n_local)
    pool = rng.permutation(len(labels))
    bounds = np.concatenate([[0], np.cumsum(counts)])
    # modulo wrap: the min-1 clip can push the cursor past the pool end on
    # extreme draws; wrapping keeps every client non-empty
    parts = [pool[np.arange(bounds[i], bounds[i + 1]) % len(pool)]
             for i in range(n_clients)]
    return _equalize(parts, n_local, rng)


def partition(regime: str, labels: np.ndarray, n_clients: int, seed: int = 0,
              **kw) -> np.ndarray:
    if regime not in _PARTITIONERS:
        raise ValueError(
            f"unknown regime {regime!r}; choose from {sorted(_PARTITIONERS)}")
    return _PARTITIONERS[regime](labels, n_clients, seed=seed, **kw)
