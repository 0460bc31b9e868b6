"""Multi-pod dry-run (the reference's ``repro.launch.dryrun``): trace every
(architecture x input shape x mesh) combination as the program one rank of
the production mesh runs, with no memory and no card, and take the roofline
terms from the trace.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch chatglm3-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fl          # the paper's FL round at scale

The reference forces 512 XLA host devices and compiles each step for the
mesh.  Here :func:`main` starts a fake process group of 256 or 512 ranks
(``torch.distributed``'s ``fake`` backend: collectives return at once and
move nothing) and builds the mesh over it as a ``DeviceMesh``; the
parameters, optimizer state, batch and cache are FakeTensors placed as
DTensors by :mod:`repro_torch.launch.sharding`'s specs; the step runs
under ``FakeTensorMode`` and :class:`repro_torch.launch.analysis.Counter`,
which counts rank 0's local ops and collectives.  ``--device`` is the fake
tensors' device type: ``cuda`` (the default) traces the program a card
runs, which needs a CUDA build of torch (a CPU-only build cannot place a
fake tensor on ``cuda``); ``cpu`` runs anywhere.

What the port's program does where the reference's partitioner decides:
the embeddings, each block's input and the logits are redistributed to the
batch layout (the batch over ``data`` / ``pod`` x ``data``, replicated
over ``model``), plain tensors built inside the forward count as
replicated (``implicit_replication``), and where DTensor has no sharding
rule for an op on its inputs' placements (:class:`_Reshard`) the inputs
are replicated over ``model``, then over every mesh dim, and the op runs
again, so the trace holds the gathers that cost.  Every combination's
record counts those fallbacks by op (``resharded``).  Attention is the
plain version (the flash kernel is off, as the reference's dry-run lowers
with flash off), and the FL round runs on ``stream`` or ``dot``: the
hand-written kernels refuse fake tensors.  On a CPU mesh DTensor moves a
shard from one dim to another by an all-gather and a chunk, where on
cards it runs an all-to-all, so ``--device cpu`` over-counts those moves.

The SSM scan is one registered operator
(:mod:`repro_torch.models.ssm_scan`) with its own sharding rule (the batch
over the batch axes, d_inner over ``model``) and counts, so a layer's scan
is one op to the trace, not a dispatched loop of L x S steps.  A
combination whose trace takes longer than ``--trace-timeout`` seconds
(default :data:`TRACE_TIMEOUT_S`; 0: no limit) is recorded as an error
naming the model code it was in.

Importing this module starts no process group.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import signal
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.configs import ASSIGNED, get, input_specs
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch import analysis, sharding, steps
from repro_torch.models import transformer as tf

#: seconds a combination's trace may take before it is recorded as an error
TRACE_TIMEOUT_S = 300.0

#: the reference's production meshes: (shape, axis names)
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, MESHES[multi_pod][0]))


def start_fake_group(world: int) -> None:
    """(Re)start the default process group as a fake one of ``world``
    ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_mesh(sizes: dict[str, int], device: str = "cuda"):
    """A DeviceMesh of ``sizes`` (``{axis: size}``) over a fresh fake group
    of exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    start_fake_group(math.prod(sizes.values()))
    return init_device_mesh(device, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def production_mesh(multi_pod: bool, device: str = "cuda"):
    """The (16, 16) or (2, 16, 16) production mesh over a fake group."""
    shape, axes = MESHES[multi_pod]
    return fake_mesh(dict(zip(axes, shape)), device)


class _Reshard(TorchDispatchMode):
    """Where DTensor has no sharding rule for an op on its inputs'
    placements, replicate the DTensor inputs over the model axis and run
    the op again, and failing that over every mesh dim; an in-place op's
    result is written back in its target's placements, and an in-place op
    on a plain tensor (a buffer built in the forward, so replicated) with
    DTensor inputs runs on their whole values.
    ``counts`` holds the fallbacks by op.  A dispatch mode, so the backward
    (and a remat block's forward run again inside it) falls back alike.
    Entered above the :class:`~repro_torch.launch.analysis.Counter`, which
    then counts the redistributions and the op's local work."""

    def __init__(self):
        super().__init__()
        self.counts: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if func is torch.ops.aten.index_copy_.default:
            return _index_copy_block(*args, **kwargs)
        if func is torch.ops.aten.detach_.default:
            # moves no data; some torch versions give DTensor no rule
            return args[0]
        written = [i for i, a in enumerate(func._schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write
                   and i < len(args)]
        if any(not isinstance(args[i], DTensor) for i in written):
            # a plain buffer (built in the forward, so replicated) written
            # with DTensor values, which DTensor cannot dispatch: each rank
            # writes the whole values into its own copy
            self.counts[func._schema.name.split("::")[-1]] += 1
            return func(*tree_map(_whole, args), **tree_map(_whole, kwargs))
        try:
            out = func(*args, **kwargs)
            # a view that splits a sharded dim leaves a strided shard,
            # which DTensor cannot gather back on fake tensors
            if not _any_strided(out):
                return out
        except Exception:
            pass
        mesh = next(t.device_mesh for t in tree_leaves((args, kwargs))
                    if isinstance(t, DTensor))
        # replicated over model, then over every mesh dim (the batch axes
        # last: they keep the step's data parallelism while the op allows)
        for level in range(1, mesh.ndim + 1):
            try:
                rargs, rkwargs = tree_map(
                    lambda t: _replicated(t, level), (args, kwargs))
                out = func(*rargs, **rkwargs)
            except Exception:
                if level == mesh.ndim:
                    raise
                continue
            if level < mesh.ndim and _any_strided(out):
                continue
            break
        self.counts[func._schema.name.split("::")[-1]] += 1
        for i in written:
            target = args[i]
            target.copy_(rargs[i].redistribute(target.device_mesh,
                                               target.placements))
        return args[written[0]] if written else out


def _replicated(t, level: int):
    """A DTensor with its last ``level`` mesh dims replicated (the model
    axis first); anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    places = list(t.placements)
    places[len(places) - level:] = [Replicate()] * level
    if places == list(t.placements):
        return t
    if not torch.is_grad_enabled():
        # without grad, redistributing a tensor that requires grad (a
        # parameter in a prefill) detaches its result in place, and some
        # torch versions give DTensor no rule for aten.detach_
        t = t.detach()
    return t.redistribute(t.device_mesh, places)


def _whole(t):
    """A DTensor as its whole value, replicated over every mesh dim, on
    this rank (a plain tensor); anything else as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    return _replicated(t, t.device_mesh.ndim).to_local()


def _any_strided(out) -> bool:
    """Whether an op's result holds a DTensor with a strided shard."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard

    outs = out if isinstance(out, (tuple, list)) else (out,)
    return any(isinstance(t, DTensor) and any(
        isinstance(p, _StridedShard) for p in t.placements) for t in outs)


def _index_copy_block(target, dim: int, index, source):
    """``target.index_copy_(dim, index, source)`` on a DTensor cache as each
    rank writes its own block: ``source`` in ``target``'s placements, and
    where ``target`` shards ``dim`` (a sequence-sharded cache) only the
    slots inside this rank's block are written (the others keep their
    values), with no collective.  DTensor's own rule for ``index_copy_``
    can leave the target's spec out of step with its shard."""
    from torch.distributed.tensor import DTensor

    mesh, places = target.device_mesh, target.placements
    src = source.redistribute(mesh, places).to_local() \
        if isinstance(source, DTensor) else source
    idx = index.full_tensor() if isinstance(index, DTensor) else index
    local = target.to_local()
    size, offset = sharding.local_block(mesh, target.shape, places)
    if size[dim] == target.shape[dim]:
        local.index_copy_(dim, idx, src)
        return target
    pos = idx - offset[dim]
    inside = (pos >= 0) & (pos < size[dim])
    pos = pos.clamp(0, size[dim] - 1)
    shape = [1] * local.dim()
    shape[dim] = -1
    kept = local.index_select(dim, pos)
    local.index_copy_(dim, pos, torch.where(inside.reshape(shape), src, kept))
    return target


def _batch_layout(mesh, x):
    """Placements of an activation in the batch layout (its leading dim
    over the batch axes where they divide it, replicated elsewhere)."""
    return sharding.placements(mesh, sharding.batch_specs(mesh, {"x": x})["x"])


def place_model(model: torch.nn.Module, mesh) -> None:
    """Swap every parameter of ``model`` for a DTensor placed by
    :func:`sharding.param_specs`, and redistribute the embeddings, each
    block's input and the model's logits to the batch layout."""
    from torch.distributed.tensor import DTensor

    params = {k: p.detach() for k, p in model.named_parameters()}
    placed = sharding.attach(sharding.param_specs(mesh, params), params, mesh)
    for name, dt in placed.items():
        path, _, leaf = name.rpartition(".")
        owner = model.get_submodule(path) if path else model
        owner.register_parameter(leaf, torch.nn.Parameter(dt))

    def to_batch_layout(_mod, args, kwargs):
        x = args[0]
        if isinstance(x, DTensor):
            x = x.redistribute(mesh, _batch_layout(mesh, x))
        return (x,) + tuple(args[1:]), kwargs

    def logits_to_batch_layout(_mod, _args, out):
        logits, aux = out
        return logits.redistribute(mesh, _batch_layout(mesh, logits)), aux

    # the embeddings leave a vocab-sharded lookup pending a masked sum,
    # which a remat block's second forward could not reduce again: reduce
    # it before the blocks
    embed_inputs = model.embed_inputs

    def embed_in_batch_layout(batch):
        x, n_prefix = embed_inputs(batch)
        return x.redistribute(mesh, _batch_layout(mesh, x)), n_prefix

    model.embed_inputs = embed_in_batch_layout
    for mod in model.modules():
        if isinstance(mod, tf.Block):
            mod.register_forward_pre_hook(to_batch_layout, with_kwargs=True)
    # the loss reads whole rows of logits (its gather of the gold token)
    model.register_forward_hook(logits_to_batch_layout)


@contextlib.contextmanager
def counted_step(counter: analysis.Counter | None):
    """The context a DTensor step runs in: plain tensors replicated, and
    ``counter`` (None: no counting) below the :class:`_Reshard` fallback
    (yielded, for its counts)."""
    from torch.distributed.tensor.experimental import implicit_replication

    reshard = _Reshard()
    with implicit_replication(), counter or contextlib.nullcontext(), \
            reshard:
        yield reshard


def _count(fn, args, *, chips: int, model_flops_global: float) -> tuple:
    """Run ``fn(*args)`` under a fresh Counter and the fallback; returns
    (roofline record, fallback counts, seconds)."""
    t0 = time.time()
    counter = analysis.Counter()
    counter.hold(args)
    with counted_step(counter) as reshard:
        out = fn(*args)
    t = time.time() - t0
    memory = {"argument_size_in_bytes": analysis.local_bytes(args),
              "output_size_in_bytes": analysis.local_bytes(out,
                                                           exclude=args),
              "temp_size_in_bytes": counter.peak_bytes}
    roof = analysis.roofline(counter, chips=chips,
                             model_flops_global=model_flops_global,
                             memory=memory)
    return roof, dict(reshard.counts), t


def lm_step(cfg, kind: str, mesh, specs: dict, *, model=None,
            optimizer: str = "sgd", remat: bool = True,
            device: str = "cuda") -> tuple:
    """The step of ``kind`` (train | prefill | decode) and its arguments
    on ``mesh``: the model (built from ``cfg`` with no storage under the
    caller's FakeTensorMode unless given), its parameters placed as
    DTensors, the stand-ins of ``specs`` placed by their specs, and for
    train the optimizer state.  Prefill and decode run without autograd,
    as the serve CLI runs them."""
    if model is None:
        model = tf.init(torch.Generator(), cfg, device)
    place_model(model, mesh)

    def placed(tree, spec_fn):
        return sharding.attach(spec_fn(mesh, tree), tree, mesh)

    if kind == "train":
        step, opt = steps.make_train_step(cfg, optimizer=optimizer,
                                          remat=remat)
        with torch.no_grad():
            opt_state = opt.init(dict(model.named_parameters()))
        return step, (model, opt_state,
                      placed(specs["batch"], sharding.batch_specs))
    # serving runs without autograd, as launch/serve.py runs it
    if kind == "prefill":
        return torch.no_grad()(steps.make_prefill_step(cfg)), (
            model, placed(specs["batch"], sharding.batch_specs),
            placed(specs["cache"], sharding.cache_specs))
    token = placed({"token": specs["token"]}, sharding.batch_specs)["token"]
    return torch.no_grad()(steps.make_decode_step(cfg)), (
        model, token, placed(specs["cache"], sharding.cache_specs))


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool,
                optimizer: str = "sgd", remat: bool = True,
                verbose: bool = True, device: str = "cuda") -> dict:
    """Trace one (arch, shape, mesh) combination; return its roofline
    record (``lower_s``: building and placing the stand-ins; ``trace_s``:
    the traced step)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get(arch)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod)}
    if not ok:
        rec.update(status="skipped", reason=reason)
        if verbose:
            print(f"[{rec['mesh']}] {arch} x {shape_name}: skipped ({reason})")
        return rec

    t0 = time.time()
    mesh = production_mesh(multi_pod, device)
    chips = mesh.size()
    with FakeTensorMode():
        specs = input_specs(cfg, shape_name, device=device)
        step, args = lm_step(cfg, shape.kind, mesh, specs,
                             optimizer=optimizer, remat=remat,
                             device=device)
        t_lower = time.time() - t0
        roof, resharded, t_trace = _count(
            step, args, chips=chips,
            model_flops_global=analysis.model_flops(cfg, shape))
    rec.update(status="ok", lower_s=round(t_lower, 1),
               trace_s=round(t_trace, 1), **roof)
    coll = rec.pop("collective_breakdown")
    rec["collectives"] = {k: int(v) for k, v in coll.items() if v}
    rec["resharded"] = resharded
    if verbose:
        print(f"[{rec['mesh']}] {arch} x {shape_name}: "
              f"compute={roof['compute_s']:.3e}s memory={roof['memory_s']:.3e}s "
              f"collective={roof['collective_s']:.3e}s "
              f"bottleneck={roof['bottleneck']} useful={roof['useful_ratio']:.2f} "
              f"(build {t_lower:.0f}s trace {t_trace:.0f}s)")
        print("  memory_analysis:", rec["memory_analysis"])
        print(f"  counted: flops/dev={roof['flops_per_device']:.3e} "
              f"bytes/dev={roof['bytes_per_device']:.3e} "
              f"collectives={rec['collectives']} resharded={resharded}")
    return rec


def fl_round_step(mesh, *, n_clients: int = 256, n_coalitions: int = 8,
                  backend: str = "stream", wdtype=torch.float32,
                  split: str | None = None, device: str = "cuda") -> tuple:
    """The paper's coalition round (N clients, the paper CNN, 5 local
    steps at batch 32) as one rank of ``mesh`` runs it, and its arguments
    (stand-ins under the caller's FakeTensorMode, or real tensors):
    ``split``, an axis name, gives each rank its block of N / P clients
    over that axis and the round's W columns split over it
    (``make_fl_round_step``'s mesh path); None, on a mesh of one rank
    only, runs the round without the mesh path (the same program there).
    The state is the steady round's (round 1): Step I's host reads cannot
    run on fake tensors.  Returns (step, args, D)."""
    from repro_torch.core import coalitions
    from repro_torch.models import cnn

    if split is None and mesh.size() > 1:
        raise ValueError("an FL round over more than one rank splits its "
                         "clients over a mesh axis (split=)")

    template = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                for k, v in cnn.init(torch.Generator()).items()}
    d = sum(v.numel() for v in template.values())
    n_local = n_clients // (mesh[split].size() if split else 1)
    stacked = {k: torch.empty((n_local,) + tuple(v.shape), dtype=v.dtype,
                              device=device) for k, v in template.items()}
    batch = {"x": torch.empty((n_local, 32, 28, 28, 1), device=device),
             "y": torch.empty((n_local, 32), dtype=torch.int32,
                              device=device)}
    state = coalitions.CoalitionState(
        center_idx=torch.empty((n_coalitions,), dtype=torch.long,
                               device=device), round=1)
    step = steps.make_fl_round_step(
        cnn.loss_fn, template, n_coalitions=n_coalitions, local_steps=5,
        backend=backend, wdtype=wdtype,
        shardmap_mesh=mesh if split else None, client_axis=split or "data")
    return step, (stacked, batch, state), d


def lower_fl_round(*, multi_pod: bool, n_clients: int = 256,
                   n_coalitions: int = 8, verbose: bool = True,
                   backend: str = "stream", wdtype_name: str = "float32",
                   shard_w: bool = False, shardmap: bool = False,
                   tag: str = "baseline", device: str = "cuda") -> dict:
    """Dry-run the PAPER'S federated coalition round at production scale:
    N = 256 clients sharded over the batch axes, the paper's CNN per client.

    As the reference's round shards the clients over the batch axes
    (``data``; ``pod`` x ``data`` flattened on two pods), each rank trains
    its block of N / P clients and the round's W columns split over the
    same axes (``make_fl_round_step``'s mesh path); the ``model`` axis
    holds replicas, as the reference's partitioning leaves it.  That path
    is the counterpart of the reference's ``shard_map`` round, so
    ``shardmap`` only marks the record: the port has no partitioner to
    compare it with.  ``shard_w=True`` splits the clients and W's columns
    over ``model`` instead (16 consecutive ranks, so the round's
    collectives stay nearer a host; ``data`` then holds the replicas).
    ``backend``: ``stream`` or ``dot`` (Gram form); ``wdtype_name``:
    ``bfloat16`` halves W.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    rec = {"arch": "paper-cnn-fl", "shape": f"fl_round_n{n_clients}",
           "mesh": _mesh_name(multi_pod), "tag": tag, "backend": backend,
           "wdtype": wdtype_name, "shard_w": shard_w, "shardmap": shardmap}
    t0 = time.time()
    mesh = production_mesh(multi_pod, device)
    chips = mesh.size()
    split, round_mesh = "data", mesh
    if shard_w:
        split = "model"
    elif multi_pod:         # the clients over pod x data: one flat axis
        split = "pod_data"
        round_mesh = mesh["pod", "data"]._flatten(split)
    with FakeTensorMode():
        step, args, d = fl_round_step(
            round_mesh, n_clients=n_clients, n_coalitions=n_coalitions,
            backend=backend, wdtype=getattr(torch, wdtype_name), split=split,
            device=device)
        t_lower = time.time() - t0
        roof, _, t_trace = _count(
            step, args, chips=chips,
            model_flops_global=6.0 * d * n_clients * 32 * 5)
    rec.update(status="ok", split=split, lower_s=round(t_lower, 1),
               trace_s=round(t_trace, 1), **roof)
    coll = rec.pop("collective_breakdown")
    rec["collectives"] = {k: int(v) for k, v in coll.items() if v}
    if verbose:
        print(f"[{rec['mesh']}] FL coalition round (N={n_clients}, "
              f"K={n_coalitions}): compute={roof['compute_s']:.3e}s "
              f"memory={roof['memory_s']:.3e}s "
              f"collective={roof['collective_s']:.3e}s "
              f"bottleneck={roof['bottleneck']}")
        print("  memory_analysis:", rec["memory_analysis"])
        print("  collectives:", rec["collectives"])
    return rec


class TraceTimeout(BaseException):
    """A combination's trace outlived ``--trace-timeout``.  Not an
    Exception: the fallback and torch's own handlers must not take it for
    an op's failure and carry on."""


@contextlib.contextmanager
def _time_limit(seconds: float | None):
    """Raise :class:`TraceTimeout` in the block after ``seconds`` (None or
    0: no limit), naming the innermost frame of the port's models it was
    in.  A raise that lands in a callback whose exceptions Python prints
    and drops (a weakref finalizer of the counter's) is lost, so the timer
    fires again every second until one lands."""
    if not seconds:
        yield
        return

    def expire(_sig, frame):
        where = ""
        while frame is not None:
            path = frame.f_code.co_filename.replace(os.sep, "/")
            if "repro_torch/models/" in path:
                where = (f" in {path.split('src/')[-1]}:{frame.f_lineno} "
                         f"({frame.f_code.co_name})")
                break
            frame = frame.f_back
        raise TraceTimeout(f"the trace took longer than {seconds:g} s{where}")

    before = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds, 1.0)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, before)


def _append(path: str, record: dict) -> None:
    """Append one JSONL record as soon as it is made (a long sweep keeps
    what it has done)."""
    with open(path, "a") as f:
        f.write(json.dumps(record, default=float) + "\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="architecture id")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="all assigned (arch x shape) combos")
    ap.add_argument("--fl", action="store_true",
                    help="dry-run the paper's coalition FL round at scale")
    ap.add_argument("--fl-backend", default="stream", choices=["stream", "dot"])
    ap.add_argument("--fl-wdtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--fl-shard-w", action="store_true",
                    help="split the clients and W's columns over the model axis")
    ap.add_argument("--fl-shardmap", action="store_true",
                    help="mark the record as the reference's shard_map round "
                         "(the port's round always splits the clients "
                         "explicitly over the batch axes)")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default=None,
                    help="append each JSONL record here as it is made")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the fake tensors (default cuda)")
    ap.add_argument("--trace-timeout", type=float, default=TRACE_TIMEOUT_S,
                    help="seconds a combination's trace may take before it "
                         "is recorded as an error (default %(default)g; "
                         "0: no limit)")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    combos = []
    if args.all:
        combos = [(a, s) for a in ASSIGNED for s in SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    elif not args.fl:
        ap.error("need --arch+--shape, --all, or --fl")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device; pass --device cpu to trace the "
              "program on the CPU", file=sys.stderr)
        raise SystemExit(1)

    records = []
    try:
        for multi in meshes:
            if args.fl:
                records.append(lower_fl_round(
                    multi_pod=multi, backend=args.fl_backend,
                    wdtype_name=args.fl_wdtype, shard_w=args.fl_shard_w,
                    shardmap=args.fl_shardmap, tag=args.tag,
                    device=args.device))
                if args.out:
                    _append(args.out, records[-1])
            for arch, shp in combos:
                try:
                    with _time_limit(args.trace_timeout):
                        records.append(lower_combo(
                            arch, shp, multi_pod=multi,
                            optimizer=args.optimizer,
                            remat=not args.no_remat, device=args.device))
                except (Exception, TraceTimeout) as e:
                    traceback.print_exc()
                    records.append({"arch": arch, "shape": shp,
                                    "mesh": _mesh_name(multi),
                                    "status": "error",
                                    "error": f"{type(e).__name__}: {e}"})
                if args.out:
                    _append(args.out, records[-1])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    n_ok = sum(r.get("status") == "ok" for r in records)
    n_skip = sum(r.get("status") == "skipped" for r in records)
    n_err = len(records) - n_ok - n_skip
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped (documented), {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
