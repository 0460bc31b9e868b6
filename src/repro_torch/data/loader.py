"""Federated dataset assembly (numpy; a copy of ``repro.data.loader``)."""
from __future__ import annotations

import numpy as np


def client_datasets(x: np.ndarray, y: np.ndarray, index_matrix: np.ndarray):
    """Gather per-client shards into stacked arrays.

    Returns a dict pytree {'x': (n_clients, n_local, ...), 'y': (n_clients,
    n_local)} ready for the vmapped ClientUpdate.
    """
    return {"x": x[index_matrix], "y": y[index_matrix]}


def label_histogram(y: np.ndarray, index_matrix: np.ndarray,
                    n_classes: int = 10) -> np.ndarray:
    """(n_clients, n_classes) label counts — used to verify regimes."""
    return np.stack([np.bincount(y[row], minlength=n_classes)
                     for row in index_matrix])
