"""Compute-backend registry for the distance/barycenter primitives.

The coalition engine needs three base primitives:

  ``pairwise_sq_dists(w) -> (N, N)``        — §III.A distance matrix
  ``sq_dists_to_points(w, p) -> (N, K)``    — assignment + medoid distances
  ``segment_sum(onehot, w) -> (K, D)``      — §III.B barycenter reduction

plus one optional fused primitive, ``fused_round(w, center_idx, *,
client_weights=None) -> FusedStats``: Algorithm 1's server step as two
streaming passes over W (:mod:`repro_torch.core.fused`).  A backend that
omits it is served by the generic composition of the three base primitives.

Registered backends:

  ``stream`` — diff-form chunked stream in plain PyTorch (the counterpart of
               the reference's ``xla``); registered by ``distance.py``.
  ``dot``    — Gram form (the counterpart of ``dot``); ``distance.py``.
  ``cuda``   — the counterpart of ``pallas``: its ``fused_round`` runs the two
               hand-written kernels of :mod:`repro_torch.kernels.fused_round`,
               its three base primitives those of
               :mod:`repro_torch.kernels.pairwise_dist` and
               :mod:`repro_torch.kernels.segment_mean` (the plain versions for
               CPU tensors).  Each base primitive counts its sweep over W.

A second optional field, ``sketched_fused_round(w, center_idx, *,
sketcher, client_weights=None, chunk=None) -> FusedStats``, is set only by
backends that must own the sketch themselves:
:func:`repro_torch.core.sharded.sharded_backend` sums the partial sketches
of each rank's column tile over its mesh axis.  Without it the dispatcher
sketches W densely and runs the shared sketched round.

Each primitive takes a ``chunk=`` hint (the streaming sweeps' column tile)
that the backends which do not stream ignore.  Backends compose: the
sharded wrapper is an unregistered Backend (name ``cuda@data2`` etc.) that
:func:`get_backend` passes through by instance.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, NamedTuple

import torch

from repro_torch.core import instrument
from repro_torch.kernels import ops as kops

if TYPE_CHECKING:   # runtime import would cycle (fused.py imports backends)
    from repro_torch.core.fused import FusedStats


class Backend(NamedTuple):
    """One implementation of the coalition-engine primitives."""

    name: str
    pairwise_sq_dists: Callable[..., torch.Tensor]
    sq_dists_to_points: Callable[..., torch.Tensor]
    segment_sum: Callable[..., torch.Tensor]
    #: optional two-pass fused round; None = the generic composition
    fused_round: Callable[..., "FusedStats"] | None = None
    #: optional sketched round ``(w, center_idx, *, sketcher, ...)``; None =
    #: the dispatcher sketches W densely and runs the shared sketched round
    sketched_fused_round: Callable[..., "FusedStats"] | None = None


_BACKENDS: dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    """Register (or override) a backend under ``backend.name``."""
    _BACKENDS[backend.name] = backend
    return backend


def get_backend(backend: str | Backend) -> Backend:
    """Resolve a backend name (or pass a :class:`Backend` through)."""
    if isinstance(backend, Backend):
        return backend
    try:
        return _BACKENDS[backend]
    except KeyError:
        raise KeyError(
            f"unknown backend {backend!r}; available: {available_backends()}"
        ) from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def _register_cuda() -> None:
    # the kernels sweep D in their own tiles: the chunk hint is ignored
    def _pairwise(w, chunk=None):
        instrument.count_w_pass()
        return kops.pairwise_sq_dists(w.contiguous())

    def _to_points(w, p, chunk=None):
        instrument.count_w_pass()
        return kops.sq_dists_to_points(w.contiguous(), p.contiguous())

    def _segment_sum(onehot, w, chunk=None):
        instrument.count_w_pass()
        return kops.segment_sum(onehot.float().contiguous(), w.contiguous())

    def _fused_round(w, center_idx, *, client_weights=None, chunk=None):
        from repro_torch.core import fused as fz

        return fz.fused_round_cuda(w, center_idx,
                                   client_weights=client_weights)

    register_backend(Backend(
        name="cuda", pairwise_sq_dists=_pairwise,
        sq_dists_to_points=_to_points, segment_sum=_segment_sum,
        fused_round=_fused_round))


_register_cuda()
