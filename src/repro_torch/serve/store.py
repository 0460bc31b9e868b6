"""ModelStore — the producer/consumer handoff between training and serving
(the port's counterpart of ``repro.serve.store``, same on-disk format).

A running :class:`repro_torch.core.server.Federation` (the producer, via
``run(snapshot_every=k, store=...)``) publishes one *round snapshot* per
cadence tick; a serving front end (the consumer,
:mod:`repro_torch.serve.frontend`) polls :meth:`ModelStore.latest_round`
and hot-swaps whatever is newest.  Both sides only touch the filesystem, so
they can live in different processes (``launch/train.py`` and
``launch/serve.py`` are that pair) — or in different packages: a snapshot
names θ by the reference's leaf paths, so the reference's server reads the
port's snapshots and the other way round.

A snapshot carries the global model θ^(r), all K coalition barycenters of
that round and the round's client→coalition assignment (the routing
table's source of truth).  Storage rides on :mod:`repro_torch.checkpoint`:
the atomic ``step_<round>/arrays.npz + meta.json`` layout, plus a retention
policy (``keep=n`` prunes the oldest published rounds, never the newest).
"""
from __future__ import annotations

import os
import shutil
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import checkpoint

#: schema tag written into every published snapshot's meta.json
SERVE_SCHEMA = "serve/v1"


class Snapshot(NamedTuple):
    """One published round, as the consumer sees it."""

    round: int
    global_params: dict        # θ^(r), nested dict by reference leaf names
    barycenters: torch.Tensor  # (K, D) per-coalition flat weight vectors
    assignment: np.ndarray     # (N,) client -> coalition id of round r
    counts: np.ndarray | None  # (K,) coalition sizes/masses (if published)
    meta: dict                 # publisher metadata (engine, method, ...)


class ModelStore:
    """Filesystem store of round snapshots with retention.

    Args:
      root: store directory (created on first publish).
      keep: retain at most this many newest snapshots; older ones are
        pruned after each publish.  None = keep everything.
    """

    def __init__(self, root: str, *, keep: int | None = None):
        if keep is not None and keep < 1:
            raise ValueError(f"keep={keep} must be >= 1 (or None)")
        self.root = root
        self.keep = keep

    # -- producer side --------------------------------------------------------

    def publish(self, round_: int, global_params: dict,
                barycenters: torch.Tensor, *, assignment,
                counts=None, extra_meta: dict | None = None) -> str:
        """Atomically publish one round snapshot; returns its directory.

        ``global_params`` is θ as a reference-named tree
        (:func:`repro_torch.core.pytree.to_ref_tree`); ``barycenters`` must
        be ``(K, D)``: row ``k`` is coalition ``k``'s model for this round
        (flat rules publish θ broadcast to every row).
        """
        bary = torch.as_tensor(barycenters)
        if bary.ndim != 2:
            raise ValueError(
                f"barycenters must be (n_coalitions, D); got "
                f"{tuple(bary.shape)}")
        tree = {"global": global_params, "barycenters": bary,
                "assignment": np.asarray(assignment).astype(np.int32)}
        if counts is not None:
            # float32 like the engine's trace counts (masses, not indices)
            tree["counts"] = np.asarray(counts, dtype=np.float32)
        meta = {"schema": SERVE_SCHEMA, "n_coalitions": int(bary.shape[0]),
                **(extra_meta or {})}
        path = checkpoint.save(self.root, round_, tree, extra_meta=meta)
        self._prune()
        return path

    def _prune(self) -> None:
        if self.keep is None:
            return
        rounds = checkpoint.available_steps(self.root)
        for r in rounds[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{r:08d}"),
                          ignore_errors=True)

    # -- consumer side --------------------------------------------------------

    def rounds(self) -> list[int]:
        """Published rounds, oldest first (malformed entries skipped)."""
        return checkpoint.available_steps(self.root)

    def latest_round(self) -> int | None:
        """Newest published round, or None before the first publish."""
        return checkpoint.latest_step(self.root)

    def load(self, round_: int | None = None, device=None) -> Snapshot:
        """Load a snapshot (newest if ``round_`` is None), its tensors on
        ``device`` (default the CPU)."""
        tree, meta = checkpoint.load(self.root, round_, device=device)
        if meta.get("schema") != SERVE_SCHEMA:
            raise ValueError(
                f"{self.root} step {meta.get('step')} is not a serve "
                f"snapshot (schema={meta.get('schema')!r}); expected "
                f"{SERVE_SCHEMA!r}")
        for part in ("global", "barycenters", "assignment"):
            if part not in tree:
                raise ValueError(
                    f"serve snapshot at {self.root} is missing {part!r}")
        counts = tree.get("counts")
        return Snapshot(
            round=int(meta["step"]),
            global_params=tree["global"],
            barycenters=tree["barycenters"],
            assignment=tree["assignment"].cpu().numpy().astype(int),
            counts=None if counts is None else counts.cpu().numpy(),
            meta=meta)
