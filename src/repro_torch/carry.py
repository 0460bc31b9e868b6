"""Carry weights between the reference's parameter trees and the port's.

The reference keeps a model's parameters as a nested dict of arrays in its
own layouts (``repro.models.cnn.init``: HWIO convolutions, (in, out) dense
weights); the port keeps a flat dict of tensors in PyTorch layouts.  These
two functions translate, given a model's ``layout``, so the tests can run
both packages on the same weights.  They take and give numpy arrays (any
array that ``numpy.asarray`` accepts on the way in).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import cnn


def params_from_jax(tree, layout=cnn.REF_LAYOUT,
                    device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Reference parameter tree (nested dicts of arrays) -> port params."""
    out = {}
    for name, path, perm in layout:
        leaf = tree
        for key in path.split("/"):
            leaf = leaf[key]
        t = torch.from_numpy(np.array(leaf))
        if perm is not None:
            t = t.permute(perm)
        out[name] = t.contiguous().to(device)
    return out


def params_to_jax(params: dict[str, torch.Tensor],
                  layout=cnn.REF_LAYOUT) -> dict:
    """Port params -> reference parameter tree of numpy arrays."""
    tree: dict = {}
    for name, path, perm in layout:
        t = params[name].detach().cpu()
        if perm is not None:
            t = t.permute(*(int(i) for i in np.argsort(perm)))
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t.contiguous().numpy()
    return tree
