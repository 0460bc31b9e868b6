"""Sharding rules: parameter, batch and cache shapes -> partition specs, as
``repro.launch.sharding``.

Megatron-style tensor parallelism on the ``model`` axis, the batch (and the
MoE experts, FSDP-style) on ``data`` (+ ``pod``), under one global rule:
*shard a dim only where the axis divides it, otherwise replicate*, so every
arch of the zoo gets a spec on the same mesh (hymba's 25 query heads or
seamless's 256,206-token vocabulary replicate where chatglm3's shard).

A spec is a tuple with one entry per dim of the tensor: a mesh axis name,
a tuple of axis names (the batch over ``("pod", "data")``), or None
(replicated); ``()`` is a replicated scalar.  The functions are pure: a
mesh is read only for its axis sizes, so a mapping ``{axis: size}`` serves
as well as a DeviceMesh (``mesh.axis_sizes``).  Trees are the port's:
:func:`param_specs` takes ``{name: tensor or shape}`` as
``Transformer.named_parameters()`` names them (``layers.3.attn.wq``), in
the port's layouts: the reference's rule for a dense (in, out) weight
applies to the port's (out, in) weight transposed, and the port keeps no
leading layer axis (the reference's stacked L dim, which is never
sharded).  :func:`with_named` turns specs into DTensor placements, and
:func:`attach` places a tree of stand-ins (or of tensors) as DTensors by
their specs, as the reference's ``attach`` gives its abstract shapes their
shardings for the dry-run (:mod:`repro_torch.launch.dryrun`).
:func:`placements` also registers, once, DTensor's sharding rules for the
port's own operators (:func:`register_op_rules`), so every DTensor placed
by these specs finds them.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Mapping

from repro_torch.launch import mesh as mesh_lib

Spec = tuple

#: the LM stack's dense weights, (out, in) here and (in, out) in the
#: reference; the MoE expert stacks keep (E, d_in, d_out) on both sides
#: (the names of :mod:`repro_torch.carry`, kept here so the launch layer
#: does not import the carrying code)
_DENSE = frozenset({"wq", "wk", "wv", "wo", "wi_gate", "wi_up", "wi",
                    "in_proj", "x_proj", "dt_proj", "out_proj", "lm_head",
                    "proj", "router"})
_EXPERTS = frozenset({"wi_gate", "wi_up", "wo"})


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _axis_size(sizes: Mapping[str, int], name) -> int:
    if isinstance(name, tuple):
        return math.prod(_axis_size(sizes, n) for n in name)
    return sizes.get(name, 1)


def _fit(sizes: Mapping[str, int], dim_size: int, axis):
    """``axis`` if it divides ``dim_size``, else None (replicate)."""
    if axis is None:
        return None
    return axis if dim_size % _axis_size(sizes, axis) == 0 else None


def _batch_axis(sizes: Mapping[str, int]):
    return ("pod", "data") if "pod" in sizes else "data"


def _ref_rule(name: str, parent: str, moe_expert_axis: str) -> tuple:
    """The reference's spec of a leaf, by its name and its parent's, in the
    reference's orientation and without the stacked layer axis (missing
    trailing entries replicate)."""
    if name == "embed":
        return ("model", None)
    if name in ("lm_head", "proj"):                 # proj: modality stub
        return (None, "model")
    if parent in ("attn", "cross"):
        if name in ("wq", "wk", "wv"):
            return (None, "model")
        if name == "wo":
            return ("model", None)
        if name in ("bq", "bk", "bv"):
            return ("model",)
    if parent == "mlp":
        if name in ("wi", "wi_gate", "wi_up"):
            return (None, "model")
        if name == "wo":
            return ("model", None)
    # MoE experts: moe_expert_axis="data" is FSDP-style (experts over data,
    # the hidden dim over model; the weights all-gather every step);
    # "model" is expert parallelism (each model rank owns E/model experts
    # whole; the activations all-to-all instead)
    if parent == "moe":
        if name == "router":
            return (None, None)
        if moe_expert_axis == "model" and name in _EXPERTS:
            return ("model", None, None)
        if name in ("wi_gate", "wi_up"):
            return ("data", None, "model")
        if name == "wo":
            return ("data", "model", None)
    if parent == "ssm":
        if name in ("in_proj", "conv_w", "dt_proj"):
            return (None, "model")
        if name in ("conv_b", "dt_bias", "D"):
            return ("model",)
        if name in ("x_proj", "A_log", "out_proj"):
            return ("model", None)
    return ()                                         # norms, the rest


def _leaf_spec(sizes: Mapping[str, int], path: str, shape: tuple, *,
               moe_expert_axis: str = "data") -> Spec:
    """The spec of one of the port's parameters, by its dotted name."""
    parts = [p for p in path.split(".") if not p.isdigit()]
    name, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    dense = len(shape) == 2 and name in _DENSE and not (
        parent == "moe" and name in _EXPERTS)
    ref_shape = shape[::-1] if dense else shape
    rule = _ref_rule(name, parent, moe_expert_axis)
    rule = rule + (None,) * (len(shape) - len(rule))
    spec = tuple(_fit(sizes, n, a) for n, a in zip(ref_shape, rule))
    return spec[::-1] if dense else spec


def param_specs(mesh, params: Mapping[str, Any], *,
                moe_expert_axis: str = "data") -> dict[str, Spec]:
    """Specs of ``{name: tensor or shape}`` (the port's parameter names)."""
    sizes = mesh_lib.axis_sizes(mesh)
    return {k: _leaf_spec(sizes, k, _shape(v),
                          moe_expert_axis=moe_expert_axis)
            for k, v in params.items()}


def opt_state_specs(mesh, opt_state: Mapping[str, Any], *,
                    moe_expert_axis: str = "data") -> dict:
    """Optimizer states (``m``/``v``/``mu`` dicts by parameter name) shard
    like their parameters; the step count and other scalars replicate."""
    out: dict = {}
    for slot, leaves in opt_state.items():
        if isinstance(leaves, Mapping):
            out[slot] = param_specs(mesh, leaves,
                                    moe_expert_axis=moe_expert_axis)
        else:
            out[slot] = (None,) * len(_shape(leaves))
    return out


def batch_specs(mesh, batch: Mapping[str, Any]) -> dict[str, Spec]:
    """Input batches: the leading (global batch) dim over pod + data."""
    sizes = mesh_lib.axis_sizes(mesh)
    ba = _batch_axis(sizes)
    out = {}
    for k, v in batch.items():
        shape = _shape(v)
        out[k] = () if not shape else (
            (_fit(sizes, shape[0], ba),) + (None,) * (len(shape) - 1))
    return out


def cache_specs(mesh, cache: Mapping[str, Any]) -> dict[str, Spec]:
    """Decode caches.

    KV (L, B, Hkv, S, Dh): the batch over pod + data where it divides;
    otherwise (B = 1 at long context) the cache's sequence dim over data
    (sequence-parallel decode), the heads over model where they divide.
    SSM state (L, B, di, N): d_inner over model, the batch over data where
    it divides.
    """
    sizes = mesh_lib.axis_sizes(mesh)
    ba = _batch_axis(sizes)
    out = {}
    for name, leaf in cache.items():
        shape = _shape(leaf)
        if not shape:
            out[name] = ()
        elif name in ("k", "v"):
            _, b, h, s, _ = shape
            bax = _fit(sizes, b, ba)
            if bax is not None:
                out[name] = (None, bax, _fit(sizes, h, "model"), None, None)
            else:
                out[name] = (None, None, _fit(sizes, h, "model"),
                             _fit(sizes, s, "data"), None)
        elif name == "h":
            _, b, di, _ = shape
            out[name] = (None, _fit(sizes, b, ba), _fit(sizes, di, "model"),
                         None)
        elif name == "conv":
            _, b, _, di = shape
            out[name] = (None, _fit(sizes, b, ba), None,
                         _fit(sizes, di, "model"))
        elif name == "memory":
            b, _, d = shape
            out[name] = (_fit(sizes, b, ba), None, _fit(sizes, d, "model"))
        else:
            out[name] = (None,) * len(shape)
    return out


def cohort_matrix_spec(axis: str = "data") -> Spec:
    """The federation's (C, D) cohort weight matrix: D over ``axis``, the
    clients replicated (C is small; D is the model), so the round's
    collectives stay O(C²) (:mod:`repro_torch.core.sharded`)."""
    return (None, axis)


def fused_stats_specs(axis: str = "data"):
    """Specs of a sharded round's FusedStats: the assignment, counts and
    medoid distances replicated, the barycenter and θ tiles over
    ``axis``."""
    from repro_torch.core.fused import FusedStats   # lazy: core is heavier

    return FusedStats(assignment=(), barycenters=(None, axis), counts=(),
                      med_d2=(), theta=(axis,))


@functools.cache
def register_op_rules() -> None:
    """Register DTensor's sharding rules for the SSM scan's two operators
    (:mod:`repro_torch.models.ssm_scan`), once.  On each mesh dim a rule
    offers every tensor replicated; the batch dim sharded on every batched
    tensor, ``a`` replicated (its gradient a partial sum); or d_inner
    sharded on delta, u, ``a``, h0, y and the carries, as the SSM specs
    shard ``A_log``, ``dt_proj`` and ``conv_w`` over ``model``, with bmat
    and cmat replicated (their gradients partial sums).  Without a rule
    DTensor would refuse the op, and the dry-run's fallback would run it
    replicated over ``model``."""
    import torch
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    from repro_torch.models import ssm_scan  # noqa: F401  (the ops)

    r, b, part = Replicate(), Shard(0), Partial()

    # outputs: y, h_last, carries; inputs: delta, u, bmat, cmat, a, h0,
    # chunk, save
    @register_sharding(torch.ops.repro_torch.ssm_scan.default)
    def _scan_rule(*_args):
        return [([r] * 3, [r] * 6 + [None] * 2),
                ([b] * 3, [b] * 4 + [r, b] + [None] * 2),
                ([Shard(2), Shard(1), Shard(2)],
                 [Shard(2), Shard(2), r, r, Shard(0), Shard(1)]
                 + [None] * 2)]

    # outputs: the gradients of delta, u, bmat, cmat, a, h0; inputs: gy,
    # gh, delta, u, bmat, cmat, a, carries, chunk
    @register_sharding(torch.ops.repro_torch.ssm_scan_backward.default)
    def _scan_backward_rule(*_args):
        return [([r] * 6, [r] * 8 + [None]),
                ([b] * 4 + [part, b], [b] * 6 + [r, b, None]),
                ([Shard(2), Shard(2), part, part, Shard(0), Shard(1)],
                 [Shard(2), Shard(1), Shard(2), Shard(2), r, r, Shard(0),
                  Shard(2), None])]


def placements(mesh, spec: Spec) -> list:
    """DTensor placements of one spec on a DeviceMesh: ``Shard(d)`` on each
    mesh dim that shards tensor dim d, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    register_op_rules()
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axis in enumerate(spec):
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None:
                out[names.index(a)] = Shard(d)
    return out


def with_named(mesh, specs: Mapping[str, Any]) -> dict:
    """Each spec of a (nested) dict as its DTensor placements on ``mesh``."""
    return {k: (with_named(mesh, v) if isinstance(v, Mapping)
                else placements(mesh, v)) for k, v in specs.items()}


def local_block(mesh, shape, places) -> tuple[list[int], list[int]]:
    """(shape, offset) of this rank's block of a tensor of ``shape`` under
    ``places``: each ``Shard(d)`` cuts dim d into equal parts over its mesh
    dim, the mesh dims in order (the rules shard only dims that divide)."""
    from torch.distributed.tensor import Shard

    size, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for m, p in enumerate(places):
        if isinstance(p, Shard):
            size[p.dim] //= mesh.size(m)
            offset[p.dim] += coord[m] * size[p.dim]
    return size, offset


def attach(specs: Mapping[str, Any], tree: Mapping[str, Any], mesh) -> dict:
    """Place a (nested) dict of tensors as DTensors on ``mesh`` by their
    specs: each leaf's rank-local block (a slice of it; of a ``meta`` or
    fake stand-in, a stand-in again, with no memory) under the spec's
    :func:`placements`, with the leaf's global shape and stride."""
    import torch
    from torch.distributed.tensor import DTensor

    out = {}
    for k, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[k] = attach(specs[k], leaf, mesh)
            continue
        places = placements(mesh, specs[k])
        size, offset = local_block(mesh, leaf.shape, places)
        local = leaf
        for d, (n, lo) in enumerate(zip(size, offset)):
            if n != leaf.shape[d]:
                local = local.narrow(d, lo, n)
        # a block is a storage of its own, as a rank holds only its block
        local = local.contiguous() if local is leaf else \
            local.clone(memory_format=torch.contiguous_format)
        out[k] = DTensor.from_local(local, mesh, places,
                                    run_check=False, shape=leaf.shape,
                                    stride=leaf.stride())
    return out
