"""Roofline terms from a traced step on the H100 (the reference's
``repro.launch.analysis``).

The reference reads XLA's cost and memory analyses of a compiled SPMD
program.  PyTorch compiles nothing, so here the step itself runs under one
counting :class:`Counter` mode, entered where it sees the **rank-local**
ops: under DTensor the ops on each rank's shards, not the global ops above
them, so what it counts is the program that one card runs.  On fake tensors
(``FakeTensorMode``) the step runs with no memory and no card; on real
tensors the same mode counts a real run, so the two can be held together.

Per rank it counts:

  flops       ``torch.utils.flop_counter.flop_registry``, with
              ``aten.convolution_backward`` counted per group: the
              registry counts the weight gradient of a grouped convolution
              as if every output channel saw every input channel, so a
              vmapped local phase (``vmap`` turns N clients' convolutions
              into one of ``groups`` = N) would count ~N times its work;
              the port's registered operators (the SSM scan and its
              backward, :mod:`repro_torch.models.ssm_scan`) by their own
              cost functions, which count their bodies' eager ops (FLOPs,
              bytes and the live bytes inside the op), and the CNN block's
              forward and weight gradient
              (:mod:`repro_torch.kernels.conv_pool`) by their bodies'
              FLOPs and their kernels' bytes, so that a fake trace (the
              plain bodies) and a real run on the card (the kernels)
              count alike;
  bytes       the sum of each aten op's input and output bytes, views
              free: the traffic of an unfused eager program, the
              counterpart of XLA's "bytes accessed";
  collectives the result bytes of each ``c10d`` / ``_c10d_functional`` op
              (and DTensor's ``_dtensor::shard_dim_alltoall``),
              by the reference's five kinds, and by whether its group
              spans one host (:data:`HOST_CARDS` consecutive ranks) or
              more; each part is priced at its own bandwidth;
  memory      the live bytes of the storages the step allocates (rounded
              up to 512 on a card, as the caching allocator rounds), and
              their peak.

H100 SXM constants, per card (NVIDIA's data sheet, as the
``hopper-kernels`` guide quotes it; no TPU figure carries over):

  compute    = flops / PEAK_FLOPS          (989 TFLOP/s dense bf16)
  memory     = bytes / HBM_BW              (3.35 TB/s HBM3)
  collective = intra-host bytes / NVLINK_BW (450 GB/s each way among the
               8 cards of a host) + inter-host bytes / NIC_BW (one
               400 Gb/s NIC a card, 50 GB/s: the DGX H100's layout, an
               assumption about the cluster)
"""
from __future__ import annotations

import functools
import threading
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import conv_flop_count, flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import conv_pool
from repro_torch.models import ssm_scan

try:
    from torch.distributed.tensor import DTensor as _DTENSOR
except ImportError:             # pragma: no cover - torch without DTensor
    _DTENSOR = None

PEAK_FLOPS = 989e12          # dense bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s each way, card to card inside a host
NIC_BW = 50e9                # bytes/s per card across hosts (400 Gb/s)
HOST_CARDS = 8               # cards a host: ranks 8h .. 8h + 7

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# op-name fragments -> kind, the first match wins (reduce_scatter before
# reduce, all_gather before gather)
_KIND_BY_NAME = (("reduce_scatter", "reduce-scatter"),
                 ("all_gather", "all-gather"), ("allgather", "all-gather"),
                 ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                 ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                 ("reduce", "all-reduce"), ("gather", "all-gather"),
                 ("scatter", "reduce-scatter"), ("broadcast",
                                                 "collective-permute"),
                 ("send", "collective-permute"), ("recv",
                                                  "collective-permute"),
                 ("permute", "collective-permute"))
# c10d's ops, their functional forms, and DTensor's own all-to-all
# (``_dtensor::shard_dim_alltoall``, its shard-to-shard move on a card; on
# a CPU mesh DTensor gathers and chunks instead)
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "_dtensor")

# ops that allocate without writing: no traffic, only memory
_ALLOC_ONLY = frozenset({"empty", "empty_like", "empty_strided",
                         "new_empty", "new_empty_strided"})


def collective_kind(op) -> str | None:
    """The reference's kind of a collective op (``None`` for any other op,
    and for waits and barriers, which move no data)."""
    return _op_info(op)[0]


@functools.cache
def _op_info(op) -> tuple:
    """What the counter needs of an op's schema, once per op: (collective
    kind or None, returns a view, returns or writes into an input, moves
    no data)."""
    name = op._schema.name.split("::")[-1]
    kind = None
    if op.namespace in _COLLECTIVE_NS and "wait" not in name \
            and "barrier" not in name:
        kind = next((k for frag, k in _KIND_BY_NAME if frag in name), None)
    returns = op._schema.returns
    view = any(r.alias_info is not None and not r.alias_info.is_write
               for r in returns)
    aliases = any(r.alias_info is not None for r in returns)
    return kind, view, aliases, name in _ALLOC_ONLY


def spans_one_host(ranks) -> bool:
    """Whether a group's ranks lie on one host of :data:`HOST_CARDS`."""
    return len({r // HOST_CARDS for r in ranks}) <= 1


def _group_ranks(args) -> list[int] | None:
    """The global ranks of the process group a collective op names (a
    ``ProcessGroup`` argument, or a ``_c10d_functional`` group name)."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    for a in args:
        if isinstance(a, torch.ScriptObject):     # c10d's boxed group
            try:
                a = dist.ProcessGroup.unbox(a)
            except RuntimeError:
                continue
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(
                    c10d._resolve_process_group(a))
            except (KeyError, ValueError, RuntimeError):
                continue
    return None


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of an op's arguments or results: tensors, and lists,
    tuples and dicts of them (an op's own nesting; faster than pytree)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, (list, tuple, type({}.values()))):
        for x in tree:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple, dict)):
                out += _tensors(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _conv_backward_flops(grad_out, x, w, _bias, _stride, _padding,
                         _dilation, transposed, _output_padding, groups,
                         output_mask, *, out) -> int:
    """``aten.convolution_backward`` counted right for ``groups`` > 1: the
    input gradient as the registry counts it (w's shape already holds the
    per-group channels), the weight gradient's count divided by
    ``groups``."""
    def t(shape):
        return [shape[1], shape[0]] + list(shape[2:])

    flops = 0
    if output_mask[0]:
        flops += conv_flop_count(list(grad_out.shape), list(w.shape),
                                 list(out[0].shape), not transposed)
    if output_mask[1]:
        a, b = (grad_out, x) if transposed else (x, grad_out)
        flops += conv_flop_count(t(a.shape), t(b.shape), t(out[1].shape),
                                 False) // groups
    return flops


#: the port's registered operators -> their bodies' (FLOPs, bytes, peak
#: bytes over the inputs) as the counter would count the bodies' own ops;
#: the CNN block's two operators with the bytes their kernels move
BODY_COSTS = {torch.ops.repro_torch.ssm_scan.default: ssm_scan.forward_cost,
              torch.ops.repro_torch.ssm_scan_backward.default:
                  ssm_scan.backward_cost,
              torch.ops.repro_torch.conv_relu_pool_fwd.default:
                  conv_pool.forward_cost,
              torch.ops.repro_torch.conv_relu_pool_wgrad.default:
                  conv_pool.weight_grad_cost}


def op_flops(func, args, kwargs, out) -> int:
    """FLOPs of one aten op by the registry (0 for ops it does not list),
    with the convolution backward counted per group, and of one of the
    port's registered operators by its cost function."""
    if func in BODY_COSTS:
        return BODY_COSTS[func](*args, **kwargs)[0]
    packet = func._overloadpacket
    if packet is torch.ops.aten.convolution_backward:
        return _conv_backward_flops(*args, **kwargs, out=out)
    formula = flop_registry.get(packet)
    if formula is None:
        return 0
    return int(formula(*args, **kwargs, out_val=out))


# DTensor works out an op's sharding and output metadata by running it (or
# its decomposition) once on global-shaped fake tensors, the first time it
# meets the op at those shapes; those shadow ops are no rank's work.  While
# a Counter is open, the propagator's entry points (the class's uncached
# methods, and the propagator's cached one, which holds the uncached method
# it was built with) mark the ops they run.
_SHADOW = threading.local()
_SHADOWED = ("propagate_op_sharding_non_cached",
             "_propagate_tensor_meta_non_cached")
_OPEN = {"counters": 0, "saved": []}


def _marking(fn):
    def shadowed(*a, **k):
        _SHADOW.depth = getattr(_SHADOW, "depth", 0) + 1
        try:
            return fn(*a, **k)
        finally:
            _SHADOW.depth -= 1
    return shadowed


def _mark_shadow_ops() -> None:
    """Wrap DTensor's sharding propagation so that the ops it runs are
    marked as shadow ops (the first Counter opened does it; the last one
    closed undoes it).  Raises if this torch's DTensor lacks an entry point
    the wrap needs: its shadow ops would be counted as rank work."""
    if _OPEN["counters"] == 0 and _DTENSOR is not None:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        prop = getattr(getattr(_DTENSOR, "_op_dispatcher", None),
                       "sharding_propagator", None)
        targets = [(ShardingPropagator, n) for n in _SHADOWED] + \
            [(prop, "propagate_op_sharding")]
        missing = [n for owner, n in targets if getattr(owner, n, None) is None]
        if missing:
            raise RuntimeError(
                f"torch {torch.__version__}: DTensor's sharding propagation "
                f"has no {', '.join(missing)}, so the counter cannot leave "
                "out the ops it runs on global shapes")
        for owner, name in targets:
            orig = getattr(owner, name)
            _OPEN["saved"].append((owner, name, orig))
            setattr(owner, name, _marking(orig))
    _OPEN["counters"] += 1


def _unmark_shadow_ops() -> None:
    """Undo :func:`_mark_shadow_ops` when the last open Counter closes."""
    _OPEN["counters"] -= 1
    if _OPEN["counters"] == 0:
        while _OPEN["saved"]:
            owner, name, orig = _OPEN["saved"].pop()
            setattr(owner, name, orig)


class Counter(TorchDispatchMode):
    """Counts a step's rank-local FLOPs, bytes, collectives and memory.

    ``with Counter() as c: step(...)``; then ``c.flops``, ``c.bytes``,
    ``c.collectives`` (result bytes by kind and by ``intra_host`` /
    ``inter_host``), ``c.peak_bytes`` (the peak of the live bytes over
    those :meth:`hold` counted as held at the start).  Ops on DTensors are
    passed down to DTensor (which runs them on the shards, where this mode
    counts them), and DTensor's shape propagation is not counted.

    A backward on CUDA tensors (fake ones too) runs on autograd's device
    thread beside the calling thread, and a storage is freed in whichever
    thread drops it last, so the counts change under one lock and "inside
    an op" is a per-thread state.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: 0 for k in _COLLECTIVES}
        self.collectives.update(intra_host=0, inter_host=0)
        self.live_bytes = 0
        self.held_bytes = 0
        self._peak_live = 0
        self._storages = WeakIdKeyDictionary()
        self._lock = threading.RLock()
        self._thread = threading.local()

    def _free(self, size: int):
        def cb(_ref):
            with self._lock:
                self.live_bytes -= size
        return cb

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        with self._lock:
            if st in self._storages:
                return
            size = st.nbytes()
            if t.device.type == "cuda":
                size = -(-size // 512) * 512
            self._storages[st] = None
            weakref.finalize(st, self._free(size), None)
            self.live_bytes += size
            self._peak_live = max(self._peak_live, self.live_bytes)

    def hold(self, tree) -> None:
        """Count a tree's storages (a module's parameters and buffers, a
        DTensor's shard) as held at the step's start, so that the step's
        frees of them (an optimizer's replaced state) count as a
        ``torch.cuda.max_memory_allocated`` over ``memory_allocated`` at
        the start counts them."""
        for t in _leaf_tensors(tree):
            self._track(t)
        self.held_bytes = self.live_bytes

    def __enter__(self):
        _mark_shadow_ops()
        try:
            return super().__enter__()
        except BaseException:
            _unmark_shadow_ops()
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _unmark_shadow_ops()

    @property
    def peak_bytes(self) -> int:
        """The peak of the live bytes over those held at the start."""
        return max(self._peak_live - self.held_bytes, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _DTENSOR is not None and any(issubclass(t, _DTENSOR)
                                        for t in types):
            return NotImplemented
        if getattr(self._thread, "inside", False) or \
                getattr(_SHADOW, "depth", 0):
            return func(*args, **kwargs)
        # an op that runs other ops inside it (a fake tensor's
        # decomposition, a data check) is one op of the program
        live = self.live_bytes
        self._thread.inside = True
        try:
            out = func(*args, **kwargs)
        finally:
            self._thread.inside = False
        with self._lock:
            return self._count(func, args, kwargs, out, live)

    def _count(self, func, args, kwargs, out, live: int):
        """Count one op that has run (``live``: the live bytes before it);
        returns its result."""
        outs = _tensors(out)
        kind, view, aliases, alloc_only = _op_info(func)
        # c10d's ops write into their first argument (the output tensors)
        inplace_coll = func.namespace == "c10d"
        if not (inplace_coll or aliases):
            for t in outs:
                self._track(t)
        if kind is not None:
            result = _tensors(args[0]) if inplace_coll else outs
            moved = sum(_nbytes(t) for t in result)
            self.collectives[kind] += moved
            ranks = _group_ranks(args)
            where = ("intra_host" if ranks is None or spans_one_host(ranks)
                     else "inter_host")
            self.collectives[where] += moved
            return out
        if func.namespace == "prim" or view:
            return out
        if func in BODY_COSTS:
            flops, nbytes, peak = BODY_COSTS[func](*args, **kwargs)
            self.flops += flops
            self.bytes += nbytes
            self._peak_live = max(self._peak_live, live + peak)
            return out
        self.flops += op_flops(func, args, kwargs, out)
        if not alloc_only:
            self.bytes += sum(_nbytes(t) for t in _tensors(args))
            self.bytes += sum(_nbytes(t) for t in _tensors(kwargs))
            self.bytes += sum(_nbytes(t) for t in outs)
        return out

    @property
    def collective_bytes(self) -> int:
        return sum(self.collectives[k] for k in _COLLECTIVES)


def _leaf_tensors(tree) -> list[torch.Tensor]:
    """A tree's tensors, a module's by its parameters and buffers, each
    DTensor as its local shard."""
    out = []
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, torch.nn.Module):
            out += _leaf_tensors(list(t.parameters()) + list(t.buffers()))
        elif isinstance(t, torch.Tensor):
            out.append(t.to_local() if _DTENSOR is not None
                       and isinstance(t, _DTENSOR) else t)
    return out


def local_bytes(tree, *, exclude=()) -> int:
    """Bytes of a tree's tensors on this rank (a module's parameters and
    buffers, a DTensor's local shard), each storage once, leaving out the
    storages of ``exclude``'s tensors."""
    skip = {id(t.untyped_storage()) for t in _leaf_tensors(exclude)}
    total = 0
    for t in _leaf_tensors(tree):
        st = t.untyped_storage()
        if id(st) not in skip:
            skip.add(id(st))
            total += st.nbytes()
    return total


def roofline(counter: Counter, *, chips: int, model_flops_global: float,
             memory: dict | None = None) -> dict[str, Any]:
    """All three roofline terms (seconds) + bottleneck + usefulness ratio
    of one traced step, per card.

    Keys as the reference's; what changed: ``flops_per_device`` and
    ``bytes_per_device`` are the counter's rank-local counts (not XLA's
    cost analysis), ``hlo_flops_global`` is that count times ``chips``
    (the traced program's FLOPs over the mesh), ``collective_breakdown``
    also splits the bytes into ``intra_host`` (NVLink) and ``inter_host``
    (NIC), and ``memory_analysis`` is ``memory`` as given (the dry-run's
    argument, output and peak temporary bytes of a rank).
    """
    flops_dev = float(counter.flops)
    bytes_dev = float(counter.bytes)
    coll = dict(counter.collectives)
    coll["total"] = counter.collective_bytes
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = coll["intra_host"] / NVLINK_BW + coll["inter_host"] / NIC_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    hlo_flops_global = flops_dev * chips
    return {
        "chips": chips,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": float(coll["total"]),
        "collective_breakdown": coll,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": bottleneck,
        "model_flops_global": model_flops_global,
        "hlo_flops_global": hlo_flops_global,
        "useful_ratio": (model_flops_global / hlo_flops_global
                         if hlo_flops_global else 0.0),
        "memory_analysis": dict(memory or {}),
    }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: one token per seq
