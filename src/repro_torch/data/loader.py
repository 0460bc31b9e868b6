"""Batching helpers and federated dataset assembly (numpy; a copy of
``repro.data.loader``)."""
from __future__ import annotations

from typing import Iterator

import numpy as np


def client_datasets(x: np.ndarray, y: np.ndarray, index_matrix: np.ndarray):
    """Gather per-client shards into stacked arrays.

    Returns a dict pytree {'x': (n_clients, n_local, ...), 'y': (n_clients,
    n_local)} ready for the vmapped ClientUpdate.
    """
    return {"x": x[index_matrix], "y": y[index_matrix]}


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0,
            drop_remainder: bool = True
            ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Shuffled ``(x, y)`` minibatches of one pass (numpy's seeded order)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    stop = (len(x) // batch_size) * batch_size if drop_remainder else len(x)
    for i in range(0, stop, batch_size):
        b = idx[i:i + batch_size]
        yield x[b], y[b]


def label_histogram(y: np.ndarray, index_matrix: np.ndarray,
                    n_classes: int = 10) -> np.ndarray:
    """(n_clients, n_classes) label counts — used to verify regimes."""
    return np.stack([np.bincount(y[row], minlength=n_classes)
                     for row in index_matrix])
