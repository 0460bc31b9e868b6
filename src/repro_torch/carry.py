"""Carry weights between the reference's parameter trees and the port's.

The reference keeps a model's parameters as a nested dict of arrays in its
own layouts (``repro.models.cnn.init``: HWIO convolutions, (in, out) dense
weights); the port keeps a flat dict of tensors in PyTorch layouts.
:func:`params_from_jax` and :func:`params_to_jax` translate, given a model's
``layout`` (buffers such as ``transformer_tiny``'s int32 ``pos_ids`` and
bfloat16 leaves included), so the tests can run both packages on the same
weights.

The LM stack (``repro.models.transformer``) stacks its layers on a leading
L axis; the port's :class:`~repro_torch.models.transformer.Transformer`
keeps a module per layer.  :func:`transformer_from_jax` and
:func:`transformer_to_jax` unstack and restack them and transpose the dense
weights between (in, out) and (out, in); the MoE expert stacks keep their
(E, d_in, d_out) layout.  :func:`cache_from_jax` and :func:`cache_to_jax`
move a decode cache, whose layout is the same on both sides.  All take and
give numpy arrays (any array that ``numpy.asarray`` accepts on the way
in).

:func:`fleet_from_jax` carries a reference device table over, so the
``semi_async`` parity tests run both engines on the same fleet (the port
samples its own tables from a torch generator).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import pytree
from repro_torch.models import cnn
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.sim.devices import DeviceFleet

#: the LM stack's dense weights: (in, out) in the reference, (out, in) here
DENSE = frozenset({"wq", "wk", "wv", "wo", "wi_gate", "wi_up", "wi",
                   "in_proj", "x_proj", "dt_proj", "out_proj", "lm_head",
                   "proj", "router"})
#: the MoE expert stacks, (E, d_in, d_out) on both sides
EXPERTS = frozenset({"wi_gate", "wi_up", "wo"})


def _leaf_to_torch(leaf) -> torch.Tensor:
    """An array of any kind as a CPU tensor; numpy has no bfloat16 of its
    own, so an ml_dtypes bfloat16 array goes through f32 (lossless)."""
    arr = np.array(leaf)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr)


def tree_to_torch(tree):
    """A nested tree of arrays (dicts, lists) as the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v) for v in tree]
    return _leaf_to_torch(tree)


def _listify(node):
    """Dicts keyed 0..n-1 (a reference list, by its leaf paths) -> lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node) and \
            sorted(int(k) for k in node) == list(range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def params_from_jax(tree, layout=cnn.REF_LAYOUT,
                    device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Reference parameter tree (nested dicts and lists of arrays) -> port
    params, every leaf the layout names (float leaves and buffers) in its
    dtype (bfloat16 included)."""
    return pytree.from_ref_tree(tree_to_torch(tree), layout, device)


def params_to_jax(params: dict[str, torch.Tensor],
                  layout=cnn.REF_LAYOUT) -> dict:
    """Port params -> reference parameter tree of numpy arrays (a list
    where the reference keeps one, as ``blocks``).  numpy has no bfloat16:
    bf16 leaves come out widened to f32, exactly; cast them back on the
    reference side."""
    def to_numpy(node):
        if isinstance(node, dict):
            return {k: to_numpy(v) for k, v in node.items()}
        t = node.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _listify(to_numpy(pytree.to_ref_tree(params, layout)))


def _dense(sub: str, name: str) -> bool:
    return name in DENSE and not (sub == "moe" and name in EXPERTS)


def _to_port(name: str, leaf, sub: str = "") -> torch.Tensor:
    t = torch.from_numpy(np.array(leaf))
    return t.T.contiguous() if _dense(sub, name) else t


def _to_ref(name: str, t: torch.Tensor, sub: str = "") -> np.ndarray:
    t = t.detach().cpu()
    return (t.T if _dense(sub, name) else t).contiguous().numpy()


def _layers_from_jax(stacked: dict, n: int, device) -> list[dict]:
    """Stacked (leading L) sub-layer trees -> one dict of tensors a layer."""
    return [{sub: {k: _to_port(k, v[i], sub).to(device)
                   for k, v in leaves.items()}
             for sub, leaves in stacked.items()}
            for i in range(n)]


def _layers_to_jax(blocks) -> dict:
    """A ModuleList of blocks -> stacked (leading L) sub-layer trees."""
    return {sub: {k: np.stack([_to_ref(k, getattr(block, sub)[k], sub)
                               for block in blocks])
                  for k in leaves}
            for sub, leaves in blocks[0].named_children()}


def transformer_from_jax(tree, cfg: ModelConfig,
                         device: str | torch.device = "cpu") -> tf.Transformer:
    """Reference LM parameter tree (layers stacked on axis 0) -> the port's
    model on ``device``: the embedding, final norm and head, the blocks
    (MoE experts and router, cross-attention included), a VLM's projector
    and an encoder-decoder's encoder."""
    def move(name, leaf):
        return _to_port(name, leaf).to(device)

    params = {"embed": move("embed", tree["embed"]),
              "ln_f": {"scale": move("scale", tree["ln_f"]["scale"])},
              "layers": _layers_from_jax(tree["layers"], cfg.n_layers,
                                         device)}
    for name in ("lm_head", "proj"):
        if name in tree:
            params[name] = move(name, tree[name])
    if "encoder" in tree:
        enc = tree["encoder"]
        params["encoder"] = {
            "proj": move("proj", enc["proj"]),
            "ln_f": {"scale": move("scale", enc["ln_f"]["scale"])},
            "layers": _layers_from_jax(enc["layers"], cfg.n_enc_layers,
                                       device)}
    return tf.Transformer(cfg, params)


def transformer_to_jax(model: tf.Transformer) -> dict:
    """The port's model -> reference LM parameter tree of numpy arrays."""
    tree: dict = {"embed": _to_ref("embed", model.embed),
                  "ln_f": {"scale": _to_ref("scale", model.ln_f["scale"])},
                  "layers": _layers_to_jax(model.layers)}
    for name in ("lm_head", "proj"):
        if hasattr(model, name):
            tree[name] = _to_ref(name, getattr(model, name))
    if hasattr(model, "encoder"):
        enc = model.encoder
        tree["encoder"] = {
            "proj": _to_ref("proj", enc.proj),
            "ln_f": {"scale": _to_ref("scale", enc.ln_f["scale"])},
            "layers": _layers_to_jax(enc.layers)}
    return tree


def transformer_layout(model: tf.Transformer) -> tuple:
    """The LM's ``(parameter, reference leaf, permutation)`` layout in the
    reference's flatten order: each layer's tensor an entry of its stacked
    reference leaf (``layers/<sub>/<name>``, stacked on a leading L axis in
    layer order), dense weights transposed.  Token-only archs (no
    encoder, no modal projector)."""
    entries = []
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            i, sub, leaf = int(parts[1]), parts[2], parts[3]
            path, dense = f"layers/{sub}/{leaf}", _dense(sub, leaf)
        elif parts[0] in ("encoder", "proj"):
            raise ValueError(f"{name}: the layout covers token-only archs")
        else:
            i, path, dense = 0, "/".join(parts), _dense("", parts[-1])
        entries.append((tuple(path.split("/")), i,
                        (name, path, (1, 0) if dense else None)))
    return tuple(e for _, _, e in sorted(entries, key=lambda t: t[:2]))


def cache_from_jax(cache, device: str | torch.device = "cpu") -> dict:
    """The reference's decode cache (``k``, ``v``, ``conv``, ``h``,
    ``memory``, ``index``) -> the port's dict of tensors; the layouts are
    the same, ``index`` a 0-d int32 tensor."""
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in cache.items()}


def cache_to_jax(cache: dict) -> dict:
    """The port's decode cache -> the reference's, as numpy arrays (copies:
    decoding updates the port's tensors in place)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in cache.items()}


def fleet_from_jax(fleet) -> DeviceFleet:
    """The reference's ``DeviceFleet`` (columns of any array type) as the
    port's table of numpy float32 columns."""
    return DeviceFleet(**{f: np.array(getattr(fleet, f), np.float32)
                          for f in DeviceFleet._fields})
