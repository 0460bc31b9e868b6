"""Coalition routing table — which model answers which client's queries
(the port's copy of ``repro.serve.routing``; numpy only).

The paper's mechanism ends each round with a client→coalition assignment and
one barycenter per coalition; at inference time a client's queries should be
answered by *its coalition's* model, not the global average.  The routing
table is exactly that assignment vector, frozen at publish time, with one
serving-side rule on top:

    known client  ->  its coalition's barycenter
    anyone else   ->  the global model θ          (``GLOBAL`` sentinel)

"Anyone else" covers client ids outside the training population and ids
explicitly marked unassigned — a fresh device can always be served, it just
gets the global model until it participates in a round and lands in a
coalition.

The table also fixes the **model-row convention** the batched front end
uses: stacked model row 0 is θ, row ``1 + k`` is coalition ``k``.  Keeping
that mapping here (``model_rows``) means the store, the front end, and the
tests all agree on it by construction.
"""
from __future__ import annotations

import numpy as np

#: routing sentinel: "serve this client the global model"
GLOBAL = -1


class RoutingTable:
    """Immutable client→coalition map of one published round."""

    def __init__(self, assignment, *, n_coalitions: int | None = None):
        a = np.asarray(assignment, dtype=np.int64).reshape(-1)
        k = int(a.max()) + 1 if a.size else 0
        if n_coalitions is None:
            n_coalitions = k
        elif k > n_coalitions:
            raise ValueError(
                f"assignment references coalition {k - 1} but only "
                f"{n_coalitions} coalitions exist")
        if a.size and a.min() < GLOBAL:
            raise ValueError(
                f"assignment ids must be >= {GLOBAL} (GLOBAL); "
                f"got min {a.min()}")
        self.assignment = a
        self.n_clients = int(a.size)
        self.n_coalitions = int(n_coalitions)

    @classmethod
    def from_snapshot(cls, snap) -> "RoutingTable":
        """Build from a :class:`repro_torch.serve.store.Snapshot`."""
        return cls(snap.assignment,
                   n_coalitions=int(snap.barycenters.shape[0]))

    def route(self, client_ids) -> np.ndarray:
        """Coalition id per query; ``GLOBAL`` for unknown/unassigned clients."""
        ids = np.asarray(client_ids, dtype=np.int64).reshape(-1)
        known = (ids >= 0) & (ids < self.n_clients)
        out = np.full(ids.shape, GLOBAL, dtype=np.int64)
        out[known] = self.assignment[ids[known]]
        return out

    def model_rows(self, client_ids) -> np.ndarray:
        """Stacked-model row per query: 0 = θ, ``1 + k`` = coalition ``k``."""
        return self.route(client_ids) + 1

    def __eq__(self, other) -> bool:
        return (isinstance(other, RoutingTable)
                and self.n_coalitions == other.n_coalitions
                and np.array_equal(self.assignment, other.assignment))

    def __repr__(self) -> str:
        return (f"RoutingTable(n_clients={self.n_clients}, "
                f"n_coalitions={self.n_coalitions})")
