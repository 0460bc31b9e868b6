"""Inference-side subsystem: model store, coalition routing, batched serving.

Training publishes round snapshots (θ + per-coalition barycenters + the
assignment vector) into a :class:`ModelStore`; a :class:`BatchServer` serves
coalition-routed batched queries from the latest snapshot and hot-swaps
newer rounds into the same tensors, so a captured program keeps serving.
"""
from repro_torch.serve.frontend import BatchServer
from repro_torch.serve.routing import GLOBAL, RoutingTable
from repro_torch.serve.store import SERVE_SCHEMA, ModelStore, Snapshot

__all__ = ["GLOBAL", "SERVE_SCHEMA", "BatchServer", "ModelStore",
           "RoutingTable", "Snapshot"]
