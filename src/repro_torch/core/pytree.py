"""Parameter dict <-> flat-vector utilities.

The paper's mechanism works on flattened model weights, vectors in R^D.
These helpers turn a model's parameter dict into the ``(n_clients, D)``
weight matrix the coalition engine consumes, and back.

The columns of W follow the reference exactly (``repro.core.pytree.
client_matrix``): leaves in its flatten order, each in its layout (HWIO
convolutions, (in, out) dense weights), so W, the barycenters and θ compare
directly with the reference's.  A model's ``layout`` — ``(parameter,
reference leaf, permutation)`` triples, see ``repro_torch.models.cnn.
REF_LAYOUT`` — says how; the module keeps PyTorch layouts inside and the
permutation is applied at this boundary.  Only the floating-point leaves the
layout lists enter the geometry, in their native dtype.
"""
from __future__ import annotations

import numpy as np
import torch

Params = dict[str, torch.Tensor]


def _inverse(perm: tuple[int, ...]) -> tuple[int, ...]:
    return tuple(int(i) for i in np.argsort(perm))


def _to_ref(t: torch.Tensor, perm, lead: int) -> torch.Tensor:
    """A module-layout tensor in the reference layout (``lead`` batch dims
    stay in front)."""
    if perm is None:
        return t
    return t.permute(*range(lead), *(lead + i for i in _inverse(perm)))


def _from_ref(t: torch.Tensor, perm, lead: int) -> torch.Tensor:
    if perm is None:
        return t
    return t.permute(*range(lead), *(lead + i for i in perm))


def geometry_dtype(params: Params, layout) -> torch.dtype:
    """Promoted dtype of the layout's leaves — the native flatten dtype."""
    dtype = params[layout[0][0]].dtype
    for name, _, _ in layout[1:]:
        dtype = torch.promote_types(dtype, params[name].dtype)
    return dtype


def flatten(params: Params, layout, dtype=None) -> torch.Tensor:
    """One model's weight vector ω ∈ R^D, in the reference's column order."""
    return client_matrix({k: v[None] for k, v in params.items()}, layout,
                         dtype)[0]


def unflatten(vec: torch.Tensor, layout, like: Params) -> Params:
    """Inverse of :func:`flatten` given a template of shapes and dtypes."""
    return {name: p[0] for name, p in matrix_to_stacked(
        vec[None], layout, like).items()}


def client_matrix(stacked: Params, layout, dtype=None) -> torch.Tensor:
    """``(n_clients, D)`` weight matrix from a dict of client-stacked leaves."""
    if dtype is None:
        dtype = geometry_dtype(stacked, layout)
    leaves = [_to_ref(stacked[name], perm, 1) for name, _, perm in layout]
    n = leaves[0].shape[0]
    return torch.cat([leaf.to(dtype).reshape(n, -1) for leaf in leaves], dim=1)


def matrix_to_stacked(mat: torch.Tensor, layout, like: Params) -> Params:
    """Inverse of :func:`client_matrix`; ``like`` is one client's params."""
    n = mat.shape[0]
    out, off = {}, 0
    for name, _, perm in layout:
        t = like[name]
        ref_shape = t.shape if perm is None else tuple(
            t.shape[i] for i in _inverse(perm))
        size = t.numel()
        leaf = mat[:, off:off + size].reshape((n, *ref_shape))
        out[name] = _from_ref(leaf, perm, 1).to(t.dtype).contiguous()
        off += size
    return out


def tree_bytes(params: Params) -> int:
    """Total bytes of a parameter dict (communication accounting): every
    leaf at its own dtype's width, as ``repro.core.pytree.tree_bytes``."""
    return int(sum(t.numel() * t.element_size() for t in params.values()))
