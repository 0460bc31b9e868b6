"""Carry weights between the reference's parameter trees and the port's.

The reference keeps a model's parameters as a nested dict of arrays in its
own layouts (``repro.models.cnn.init``: HWIO convolutions, (in, out) dense
weights); the port keeps a flat dict of tensors in PyTorch layouts.
:func:`params_from_jax` and :func:`params_to_jax` translate, given a model's
``layout``, so the tests can run both packages on the same weights.

The LM stack (``repro.models.transformer``) stacks its layers on a leading
L axis; the port's :class:`~repro_torch.models.transformer.Transformer`
keeps a module per layer.  :func:`transformer_from_jax` and
:func:`transformer_to_jax` unstack and restack them and transpose the dense
weights between (in, out) and (out, in).  All four take and give numpy
arrays (any array that ``numpy.asarray`` accepts on the way in).

:func:`fleet_from_jax` carries a reference device table over, so the
``semi_async`` parity tests run both engines on the same fleet (the port
samples its own tables from a torch generator).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import cnn
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.sim.devices import DeviceFleet

#: the LM stack's dense weights: (in, out) in the reference, (out, in) here
DENSE = frozenset({"wq", "wk", "wv", "wo", "wi_gate", "wi_up", "wi",
                   "in_proj", "x_proj", "dt_proj", "out_proj", "lm_head"})


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


def _to_port(name: str, leaf) -> torch.Tensor:
    t = torch.from_numpy(np.array(leaf))
    return t.T.contiguous() if name in DENSE else t


def _to_ref(name: str, t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.T if name in DENSE else t).contiguous().numpy()


def transformer_from_jax(tree, cfg: ModelConfig,
                         device: str | torch.device = "cpu") -> tf.Transformer:
    """Reference LM parameter tree (layers stacked on axis 0) -> the port's
    model on ``device``."""
    def move(name, leaf):
        return _to_port(name, leaf).to(device)

    layers = [{sub: {k: move(k, v[i]) for k, v in leaves.items()}
               for sub, leaves in tree["layers"].items()}
              for i in range(cfg.n_layers)]
    params = {"embed": move("embed", tree["embed"]),
              "ln_f": {"scale": move("scale", tree["ln_f"]["scale"])},
              "layers": layers}
    if "lm_head" in tree:
        params["lm_head"] = move("lm_head", tree["lm_head"])
    return tf.Transformer(cfg, params)


def transformer_to_jax(model: tf.Transformer) -> dict:
    """The port's model -> reference LM parameter tree of numpy arrays."""
    tree: dict = {"embed": _to_ref("embed", model.embed),
                  "ln_f": {"scale": _to_ref("scale", model.ln_f["scale"])},
                  "layers": {}}
    for sub, leaves in model.layers[0].named_children():
        tree["layers"][sub] = {
            k: np.stack([_to_ref(k, getattr(block, sub)[k])
                         for block in model.layers])
            for k in leaves}
    if hasattr(model, "lm_head"):
        tree["lm_head"] = _to_ref("lm_head", model.lm_head)
    return tree


def fleet_from_jax(fleet) -> DeviceFleet:
    """The reference's ``DeviceFleet`` (columns of any array type) as the
    port's table of numpy float32 columns."""
    return DeviceFleet(**{f: np.array(getattr(fleet, f), np.float32)
                          for f in DeviceFleet._fields})
