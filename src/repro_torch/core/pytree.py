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
layout lists enter the geometry, in their native dtype; a non-float leaf
the layout lists (an int32 position-id buffer) is a *buffer*: it stays out
of W and rides through :func:`matrix_to_stacked` and :func:`unflatten`
untouched, taken from the template, as the reference's
``is_geometry_leaf`` rule has it.

:func:`to_ref_tree` and :func:`from_ref_tree` name a parameter dict by the
reference's leaf paths (nested dicts, reference layouts), which is how
checkpoints and serving snapshots store it, so either package reads what
the other wrote.  A reference leaf that several layout entries name (a
stack of per-layer weights) holds them stacked on a leading axis in layout
order.
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


def geometry(params: Params, layout) -> tuple:
    """The layout's entries whose leaf is floating point (the columns of
    W), in order; the others are buffers."""
    return tuple(e for e in layout if params[e[0]].is_floating_point())


def geometry_dtype(params: Params, layout) -> torch.dtype:
    """Promoted dtype of the layout's float leaves — the native flatten
    dtype."""
    entries = geometry(params, layout)
    dtype = params[entries[0][0]].dtype
    for name, _, _ in entries[1:]:
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
    """``(n_clients, D)`` weight matrix from a dict of client-stacked leaves
    (the float leaves of the layout; buffers stay out)."""
    if dtype is None:
        dtype = geometry_dtype(stacked, layout)
    leaves = [_to_ref(stacked[name], perm, 1)
              for name, _, perm in geometry(stacked, layout)]
    n = leaves[0].shape[0]
    return torch.cat([leaf.to(dtype).reshape(n, -1) for leaf in leaves], dim=1)


def matrix_to_stacked(mat: torch.Tensor, layout, like: Params) -> Params:
    """Inverse of :func:`client_matrix`; ``like`` is one client's params.
    Buffers are ``like``'s, repeated over the leading axis."""
    n = mat.shape[0]
    out, off = {}, 0
    for name, _, perm in layout:
        t = like[name]
        if not t.is_floating_point():
            out[name] = t[None].expand(n, *t.shape).contiguous()
            continue
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


def _ref_leaves(layout) -> dict[str, list]:
    """Reference leaf path -> its layout entries, in layout order."""
    groups: dict[str, list] = {}
    for entry in layout:
        groups.setdefault(entry[1], []).append(entry)
    return groups


def to_ref_tree(params: Params, layout) -> dict:
    """The parameters as the reference's nested dict of tensors: each leaf
    at its reference path, in its reference layout (detached, on the
    parameters' device, in their dtype)."""
    tree: dict = {}
    for path, entries in _ref_leaves(layout).items():
        leaves = [_to_ref(params[name].detach(), perm, 0)
                  for name, _, perm in entries]
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = (leaves[0] if len(entries) == 1
                      else torch.stack(leaves)).contiguous()
    return tree


def ref_leaf(tree, path: str):
    """The leaf at a slash-separated reference path of a nested tree
    (dicts, or lists indexed by the path's integers)."""
    node = tree
    for key in path.split("/"):
        node = node[int(key)] if isinstance(node, (list, tuple)) else \
            node[key]
    return node


def from_ref_tree(tree, layout, device=None) -> Params:
    """Inverse of :func:`to_ref_tree`: a reference-named nested tree of
    tensors -> the port's parameter dict (module layouts, contiguous)."""
    out = {}
    for path, entries in _ref_leaves(layout).items():
        leaf = torch.as_tensor(ref_leaf(tree, path), device=device)
        for i, (name, _, perm) in enumerate(entries):
            t = leaf if len(entries) == 1 else leaf[i]
            out[name] = _from_ref(t, perm, 0).contiguous()
    return out
