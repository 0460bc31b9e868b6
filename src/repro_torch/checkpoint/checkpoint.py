"""npz-based checkpoints of nested trees of tensors (the port's copy of
``repro.checkpoint``, same on-disk format).

Layout: ``<dir>/step_%08d/arrays.npz`` + ``meta.json`` (tree description,
sorted leaf names, dtypes).  Leaves are named by their slash-separated
paths (dict keys sorted, list and tuple positions as integers), as the
reference names them, so a step written by either package loads in the
other; a model's parameters go in under the reference's leaf names
(:func:`repro_torch.core.pytree.to_ref_tree`).

Two restore paths:

* :func:`restore` — template-driven: the caller supplies a ``like`` tree
  and gets the checkpoint cast into its exact structure, dtypes and
  devices.  Strict: missing, extra or renamed leaves and shape mismatches
  raise.
* :func:`load` — template-free: rebuilds a nested-``dict`` tree from the
  leaf names and the recorded dtypes (what a server uses).

``meta.json`` records each leaf's dtype before the npz f32-widening of
bfloat16 (numpy has no bfloat16), so both paths give bf16 leaves back as
bf16.  ``treedef`` holds the port's own description of the tree; the
reference's ``load`` does not read it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Iterator

import numpy as np
import torch

Tree = Any

#: schema tag written by :func:`save_federation`
FEDERATION_SCHEMA = "federation/v2"

_STEP_RE = re.compile(r"^step_(\d+)$")

#: dtype names as meta.json records them (numpy's spelling) -> torch dtypes
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32, "float64": torch.float64,
                 "int8": torch.int8, "int16": torch.int16,
                 "int32": torch.int32, "int64": torch.int64,
                 "uint8": torch.uint8, "bool": torch.bool}


def _walk(tree: Tree, path: tuple = ()) -> Iterator[tuple[str, Any]]:
    """``(name, leaf)`` in flatten order: dict keys sorted, list and tuple
    items by position; None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


def _describe(tree: Tree) -> str:
    """The tree's structure in one line (``*`` a leaf)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(v) for v in tree)
        name = type(tree).__name__
        return f"{name}({inner})" if hasattr(tree, "_fields") else \
            ("[" + inner + "]" if isinstance(tree, list) else
             "(" + inner + ")")
    return "None" if tree is None else "*"


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as an npz-ready array plus its dtype name before widening."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.float()                      # lossless
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten_with_names(tree: Tree) -> tuple[dict[str, np.ndarray],
                                              dict[str, str]]:
    flat, dtypes = {}, {}
    for name, leaf in _walk(tree):
        flat[name], dtypes[name] = _to_numpy(leaf)
    return flat, dtypes


def _tensor(arr: np.ndarray, dtype_name: str | None,
            device=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    if dtype_name is not None and dtype_name in _TORCH_DTYPES:
        t = t.to(_TORCH_DTYPES[dtype_name])
    return t if device is None else t.to(device)


def save(ckpt_dir: str, step: int, tree: Tree,
         extra_meta: dict | None = None) -> str:
    """Atomically save a tree checkpoint.  Returns the step directory.

    The staging directory lives inside ``ckpt_dir`` (same filesystem, so
    the final ``os.replace`` is atomic) with a ``.tmp-`` prefix that
    :func:`available_steps` never matches.  Re-publishing an existing step
    renames the old one to a ``.tmp-`` trash name before installing the
    new one; a failed install puts the old one back.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".tmp-step-", dir=ckpt_dir)
    flat, dtypes = _flatten_with_names(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = {
        "step": step,
        "treedef": _describe(tree),
        "names": sorted(flat),
        "dtypes": dtypes,
        **(extra_meta or {}),
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    if os.path.lexists(step_dir):
        trash = tempfile.mkdtemp(prefix=".tmp-trash-", dir=ckpt_dir)
        old = os.path.join(trash, "old")
        os.replace(step_dir, old)
        try:
            os.replace(tmp, step_dir)
        except BaseException:
            os.replace(old, step_dir)
            raise
        shutil.rmtree(trash, ignore_errors=True)
    else:
        os.replace(tmp, step_dir)
    return step_dir


def _step_path(ckpt_dir: str, step: int | None) -> tuple[str, int]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return os.path.join(ckpt_dir, f"step_{step:08d}"), step


def _rebuild(template: Tree, leaves: Iterator) -> Tree:
    """``template``'s structure with its leaves replaced in flatten order."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves)
                for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        items = [_rebuild(v, leaves) for v in template]
        if hasattr(template, "_fields"):
            return type(template)(*items)
        return type(template)(items)
    if template is None:
        return None
    return next(leaves)


def _cast_like(arr: np.ndarray, like, name: str):
    """A stored array as the template leaf's kind: a tensor of its dtype on
    its device, an array of its dtype, or a Python scalar."""
    want = tuple(like.shape) if isinstance(like, torch.Tensor) else \
        tuple(np.shape(like))
    if tuple(arr.shape) != want:
        raise ValueError(
            f"checkpoint leaf {name!r} has shape {tuple(arr.shape)} but the "
            f"template expects {want}")
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                  dtype=like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    return np.asarray(arr).astype(np.asarray(like).dtype)


def restore(ckpt_dir: str, like: Tree, step: int | None = None) -> Tree:
    """Restore into the structure of ``like`` (shape/dtype/device template).

    The checkpoint's leaf-name set must equal the template's and every
    stored array must match its template leaf's shape; missing, extra or
    renamed leaves raise a :class:`KeyError` naming the offenders.
    """
    step_dir, step = _step_path(ckpt_dir, step)
    arrays = np.load(os.path.join(step_dir, "arrays.npz"))
    named = list(_walk(like))
    names = [n for n, _ in named]
    missing = set(names) - set(arrays.files)
    extra = set(arrays.files) - set(names)
    if missing or extra:
        raise KeyError(
            f"checkpoint step {step} does not match the template: "
            f"missing leaves {sorted(missing)[:5]}, "
            f"extra/renamed leaves {sorted(extra)[:5]} "
            f"(template has {len(names)} leaves, checkpoint "
            f"{len(arrays.files)})")
    return _rebuild(like, iter([_cast_like(arrays[n], l, n)
                                for n, l in named]))


def load(ckpt_dir: str, step: int | None = None,
         device=None) -> tuple[dict, dict]:
    """Template-free load: ``(nested-dict tree of tensors, meta)``.

    Nesting comes from the slash-separated leaf names and each leaf is cast
    back to its recorded dtype (bfloat16 leaves come back bf16 though npz
    stored them widened to f32), on ``device`` (default the CPU).  All
    mappings come back as plain ``dict``s.
    """
    step_dir, step = _step_path(ckpt_dir, step)
    arrays = np.load(os.path.join(step_dir, "arrays.npz"))
    with open(os.path.join(step_dir, "meta.json")) as f:
        meta = json.load(f)
    dtypes = meta.get("dtypes", {})
    tree: dict = {}
    for name in arrays.files:
        parts = name.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(
                    f"leaf name {name!r} collides with another leaf's path")
        if parts[-1] in node:
            raise ValueError(
                f"leaf name {name!r} collides with another leaf's path")
        node[parts[-1]] = _tensor(arrays[name], dtypes.get(name), device)
    return tree, meta


def available_steps(ckpt_dir: str) -> list[int]:
    """Sorted step numbers with a complete ``step_<n>`` directory;
    malformed entries (a stray ``step_foo``, an interrupted staging
    directory) are skipped."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if m is not None and os.path.isdir(os.path.join(ckpt_dir, d)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def indexed(tree: Tree) -> dict[str, Any]:
    """Leaves as an order-indexed dict (``{'0000': leaf, ...}``), for
    subtrees whose container types would not survive :func:`load`; the
    consumer rebuilds them with :func:`from_indexed` and a template."""
    return {f"{i:04d}": leaf for i, (_, leaf) in enumerate(_walk(tree))}


def from_indexed(flat: dict, template: Tree) -> Tree:
    """Inverse of :func:`indexed` given a structure template: each leaf
    cast to the template leaf's kind, dtype and device."""
    names = sorted(flat)
    leaves_t = [l for _, l in _walk(template)]
    if len(names) != len(leaves_t):
        raise ValueError(
            f"checkpoint carry has {len(names)} leaves but the template "
            f"has {len(leaves_t)} — wrong engine or config?")
    return _rebuild(template, iter(
        [_cast_like(_numpy_of(flat[n]), lt, n)
         for n, lt in zip(names, leaves_t)]))


def _numpy_of(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return _to_numpy(leaf)[0]
    return np.asarray(leaf)


def save_federation(ckpt_dir: str, round_: int, global_params: dict,
                    state: Tree, history: dict | None = None, *,
                    carry: Tree | None = None,
                    trace: dict | None = None,
                    extra_meta: dict | None = None) -> str:
    """Federation snapshot: global model + strategy state (+ resume payload).

    Schema (``meta['schema'] == 'federation/v2'``)::

        global/...       the θ tree by the reference's leaf names
        strategy/<i>     the strategy's state leaves, order-indexed
        round            () int32
        carry/...        (optional) the engine's whole resume carry by
                         its own leaf names (generator states as uint8
                         arrays; the reference indexes its carry by
                         position, a JAX scan carry having no names)
        trace/<name>     (optional) the stacked per-round metric arrays for
                         rounds 0..round_
    """
    tree: dict[str, Any] = {"global": global_params,
                            "strategy": indexed(state),
                            "round": np.int32(round_)}
    if carry is not None:
        tree["carry"] = carry
    if trace is not None:
        tree["trace"] = dict(trace)
    meta = {"history": history or {}, "schema": FEDERATION_SCHEMA,
            **(extra_meta or {})}
    return save(ckpt_dir, round_, tree, extra_meta=meta)
