"""Mesh-parallel fused round: the (N, D) client matrix split along D over
the ``data`` ranks of a mesh, as ``repro.core.sharded``.

Each rank holds a contiguous (N, D_pad / P) column tile of W (D zero-padded
to a multiple of P; zero columns add nothing to any sum of squares or
product) and runs the two-pass fused round on it, with two all-reduces of
small matrices stitching the passes together:

  pass 1 — every rank's partial (N, K) center distances (on ``dot`` its
           partial (N, N) Gram matrix), summed over the ranks; assignment,
           the aggregation matrix and the empty-coalition fallback are then
           O(N·K) algebra, the same on every rank;
  pass 2 — every rank's (K, D_pad / P) barycenter tile and (D_pad / P,) θ
           tile, which stay on their rank, and its partial (N, K) medoid
           distances, summed over the ranks.

Each rank reads its tile exactly twice (:func:`instrument.count_w_pass`
counts per rank), and the collectives move O(N²) floats a round, never
O(D).  The returned :class:`~repro_torch.core.fused.FusedStats` carries the
replicated assignment, counts and ``med_d2`` and this rank's barycenter and
θ **tiles**, as the reference's stay D-sharded; :func:`gather_cols`
assembles a whole θ (or the barycenters) where the caller needs one, the
one O(D) collective of a round (the federation needs a whole θ for the next
local phase).

The per-rank bodies are the dense rounds of :mod:`repro_torch.core.fused`
themselves, run on the rank's tile with their ``reduce`` hook an all-reduce
over the mesh axis: the counterparts of the reference's ``_local_xla``
(``stream``), ``_local_dot`` (``dot``) and ``_local_pallas`` (``cuda``: the
fused round's two hand-written kernels on the rank's tile, which must be
contiguous, as the kernels refuse views).  The sketched round (the
reference's ``_local_sketched``): each rank sketches its own columns at
their global offset, the partial (N, S) sketches are summed, and the dense
sketched round runs on the tile, its sketch-space distances plain torch
(as the reference's ``_sq_to_points``) and its pass 2 the barycenter sweep
alone (``segment_sum`` on ``cuda``).

On a one-rank mesh every all-reduce is a sum over one term and the tile is
W itself, so the sharded round equals the dense one bit for bit.

Entry point: :func:`sharded_backend` wraps a registered base backend
(``stream`` | ``dot`` | ``cuda``) into a Backend named e.g. ``cuda@data2``
whose ``fused_round`` and ``sketched_fused_round`` are the sharded ones; the
three base primitives pass through, so the composed path and
``init_centers`` keep running dense on the wrapped backend.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core import backends as bk
from repro_torch.core import fused as fz
from repro_torch.core import instrument
from repro_torch.core import sketch as sk_mod


# --- the column split ------------------------------------------------------------

def _split(mesh, axis: str, d: int) -> tuple:
    """(group, parts, rank, width of a tile, first column of this rank's)."""
    group = mesh.get_group(axis)
    parts = dist.get_world_size(group)
    rank = dist.get_rank(group)
    width = -(-d // parts)
    return group, parts, rank, width, rank * width


def column_tile(w: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous (N, D_pad / P) column tile of ``w`` over
    ``axis`` (:func:`cut_tile`)."""
    _, parts, rank, _, _ = _split(mesh, axis, w.shape[1])
    return cut_tile(w, parts, rank)


def cut_tile(w: torch.Tensor, parts: int, rank: int) -> torch.Tensor:
    """Tile ``rank`` of ``parts``: the contiguous (N, ceil(D / parts))
    block of columns from ``rank * ceil(D / parts)``, the columns past D
    zero (at one part, ``w`` itself where it is contiguous)."""
    n, d = w.shape
    if parts == 1:
        return w.contiguous()
    width = -(-d // parts)
    lo = rank * width
    valid = max(0, min(width, d - lo))
    if valid == width:
        return w[:, lo:lo + width].contiguous()
    tile = w.new_zeros((n, width))
    tile[:, :valid] = w[:, lo:lo + valid]
    return tile


def gather_cols(tile: torch.Tensor, mesh, d: int,
                axis: str = "data") -> torch.Tensor:
    """The whole (..., D) tensor from every rank's (..., D_pad / P) column
    tile: an all-gather over ``axis``, cut back to D columns."""
    group = mesh.get_group(axis)
    parts = dist.get_world_size(group)
    tile = tile.contiguous()
    tiles = [torch.empty_like(tile) for _ in range(parts)]
    dist.all_gather(tiles, tile, group=group)
    return torch.cat(tiles, dim=-1)[..., :d]


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def summed(t: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """``t`` summed over the ranks of ``axis`` (an all-reduce)."""
    return _summed(t, mesh.get_group(axis))


# --- per-rank bodies: the dense rounds with their partials summed ---------------

#: the dense rounds of :mod:`repro_torch.core.fused`, run on a rank's tile
#: with ``reduce`` an all-reduce over the mesh axis (the counterparts of the
#: reference's ``_local_xla``, ``_local_dot`` and ``_local_pallas``)
_LOCALS: dict[str, Callable] = {"stream": fz.fused_round_stream,
                                "dot": fz.fused_round_dot,
                                "cuda": fz.fused_round_cuda}


def _partial_sketch(sketcher, w_loc, *, valid, lo, group):
    """The replicated (N, S) sketch: each rank sketches its tile's ``valid``
    real columns at global offset ``lo``, and the partials are summed."""
    instrument.count_w_pass()                    # sketch sweep (tile)
    if valid:
        part = sk_mod.sketch_block(sketcher, w_loc[:, :valid], col_offset=lo)
    else:                                        # a tile of padding alone
        part = torch.zeros((w_loc.shape[0], sketcher.dim),
                           dtype=torch.float32, device=w_loc.device)
    return _summed(part.float(), group)


# --- the wrapped rounds ----------------------------------------------------------

def _tile_of(w, mesh, axis, tiled_d):
    """(this rank's tile, D, group, tile width, its first column)."""
    d = w.shape[1] if tiled_d is None else tiled_d
    group, _, _, width, lo = _split(mesh, axis, d)
    if tiled_d is None:
        w = column_tile(w, mesh, axis)
    elif w.shape[1] != width:
        raise ValueError(f"a tile of an (N, {d}) matrix over this mesh is "
                         f"{width} columns wide, got {w.shape[1]}")
    return w.contiguous(), d, group, width, lo


def _sharded_fused_round(local, mesh, axis, tiled_d, w, center_idx, *,
                         client_weights=None, chunk=None):
    tile, _, group, _, _ = _tile_of(w, mesh, axis, tiled_d)
    return local(tile, center_idx, client_weights=client_weights,
                 chunk=chunk, reduce=functools.partial(_summed, group=group))


def _sharded_sketched_round(base, mesh, axis, tiled_d, w, center_idx, *,
                            sketcher, client_weights=None, chunk=None):
    """The sketch summed from the tiles, then the dense sketched round on
    the tile: assignment and the medoid election on the replicated sketch
    (plain ``stream`` distances, as the reference's ``_sq_to_points``), the
    barycenter sweep (``segment_sum``) on the tile alone."""
    tile, d, group, width, lo = _tile_of(w, mesh, axis, tiled_d)
    s_w = _partial_sketch(sketcher, tile, valid=max(0, min(width, d - lo)),
                          lo=lo, group=group)
    return fz.sketched_fused_round(base, tile, s_w, center_idx,
                                   client_weights=client_weights,
                                   sketch_backend=bk.get_backend("stream"))


def sharded_backend(base: str | bk.Backend, mesh, *, axis: str = "data",
                    tiled_d: int | None = None) -> bk.Backend:
    """Wrap a registered backend's fused and sketched rounds in mesh-parallel
    ones over ``axis`` of ``mesh`` (a DeviceMesh from
    :mod:`repro_torch.launch.mesh`).  The name records the sharding
    (``"cuda@data2"``).  Its rounds take the whole (N, D) matrix and cut
    this rank's tile, or, with ``tiled_d``, take the rank's tile of an
    (N, tiled_d) matrix itself (:func:`repro_torch.launch.steps.
    make_fl_round_step` builds the tiles by an all-to-all); either way they
    return this rank's barycenter and θ column tiles (see the module
    docstring)."""
    base = bk.get_backend(base)
    if base.name not in _LOCALS:
        raise ValueError(
            f"no sharded fused round for backend {base.name!r} "
            f"(choose from {sorted(_LOCALS)})")
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no {axis!r} axis (axes: {names})")
    size = mesh.shape[names.index(axis)]
    return base._replace(
        name=f"{base.name}@{axis}{size}",
        fused_round=functools.partial(_sharded_fused_round,
                                      _LOCALS[base.name], mesh, axis,
                                      tiled_d),
        sketched_fused_round=functools.partial(_sharded_sketched_round,
                                               base, mesh, axis, tiled_d))
