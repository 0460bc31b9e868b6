"""The paper CNN's first block as a kernel pair (``csrc/conv_pool.cu``).

The block is ``max_pool2d(relu(conv1(x) + b), 2)``: 32 filters of 5x5 over
one 28x28 channel, valid padding, the bias before the ReLU, a 2x2 max-pool
of stride 2.  It replaces no TPU kernel (XLA ran it there): under
``torch.func.vmap`` with per-client weights ATen sent conv1 to its native
depthwise kernels, which ran at 1.4-2.9 TFLOP/s and with the two pools and
ReLUs took about a quarter of the FL local phase's device time.  The source
note in ``csrc/conv_pool.cu`` gives the design.

Everything here is client-batched.  With C clients of B images each:

- :func:`forward`: x (C, B, 1, 28, 28) f32 (a client stride of 0 shares
  one batch), w (C, 32, 1, 5, 5), b (C, 32) -> y (B, C, 32, 12, 12), the
  pooled activations, and ``argmax`` (B, C, 32, 12, 12) uint8, the index
  ``2 dy + dx`` of the window's first maximum after the ReLU, as ATen's
  max-pool picks it.  y is laid out as conv2's grouped call under ``vmap``
  reads it, (B, C * 32, 12, 12), so no copy sits between the two.
- :func:`weight_grad`: the gradient of y (B, C, 32, 12, 12), argmax, y and
  x -> dW (C, 32, 1, 5, 5), db (C, 32).  Only a window's maximum carries
  gradient, and only where y > 0 (the ReLU's mask: y = relu(max)).  There
  is no input gradient: x is data on every path.

:func:`conv_relu_pool` is the block as the model calls it, x (B, 1, 28, 28)
-> (B, 32, 12, 12), differentiable in w and b.  It is a
``torch.autograd.Function`` with a ``vmap`` rule, whose backward is the
operator ``repro_torch::conv_relu_pool_wgrad`` with a vmap rule of its
own, so that ``vmap(grad_and_value(...))`` over the clients makes one
client-batched call each way; a nested ``vmap`` folds its clients into C.
Both directions run as operators (``repro_torch::conv_relu_pool_fwd`` and
``_wgrad``), which the dry-run's counter counts by their cost functions.

A CUDA tensor goes to the kernels (the wrapper checks device, dtype, shape
and strides, allocates with ``torch.empty``, launches on the current stream,
raises if the launch fails and adds one to :data:`LAUNCHES`); there is no
fallback.  A CPU or meta tensor, and the dry-run's fake tensors, take the
plain versions :func:`plain_forward` and :func:`plain_weight_grad`
(grouped ``F.conv2d``, ReLU and ``max_pool2d``; ``convolution_backward``
on the unpooled, masked gradient).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import build

#: launches of each kernel in this process (see :func:`reset_launch_counts`)
LAUNCHES = {"conv_relu_pool_fwd": 0, "conv_relu_pool_wgrad": 0}

#: the block's fixed shape: input side, filters, filter side, pooled side
HW, FILTERS, K = 28, 32, 5
POOLED = (HW - K + 1) // 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib: ctypes.CDLL | None = None
#: weight-gradient CTAs the card holds at once, by device index (the
#: wrapper splits each client's images into runs until C x runs CTAs fill
#: the card once)
_SLOTS: dict[int, int] = {}
#: each (device, stream)'s zeroed tickets of the weight gradient's splits
#: (one a client; the last CTA of a client sets its ticket back to 0)
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(t: torch.Tensor) -> bool:
    if isinstance(t, FakeTensor) or t.device.type in ("cpu", "meta"):
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"conv_relu_pool: no kernel for tensors on {t.device}")


# ------------------------------------------------------------ plain versions

def plain_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """:func:`forward` in plain PyTorch: one grouped convolution over the
    clients (the bias added after it, as ``vmap``'s convolution rule does),
    ReLU, ``max_pool2d`` with its indices turned into window indices."""
    c, n = x.shape[:2]
    xg = x.reshape(c, n, HW, HW).transpose(0, 1).reshape(n, c, HW, HW)
    h = F.conv2d(xg, w.reshape(c * FILTERS, 1, K, K), groups=c)
    h = F.relu(h + b.reshape(1, c * FILTERS, 1, 1))
    y, idx = F.max_pool2d(h, 2, return_indices=True)
    side = 2 * POOLED
    argmax = ((idx // side) % 2 * 2 + idx % 2).to(torch.uint8)
    shape = (n, c, FILTERS, POOLED, POOLED)
    return y.reshape(shape), argmax.reshape(shape)


def plain_weight_grad(g: torch.Tensor, argmax: torch.Tensor, y: torch.Tensor,
                      x: torch.Tensor):
    """:func:`weight_grad` in plain PyTorch: the masked gradient put back
    at each window's maximum (every unpooled position lies in one window),
    then the grouped convolution's weight and bias gradients."""
    n, c = g.shape[:2]
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    e = torch.where(y > 0, g, zero)
    window = torch.arange(4, dtype=argmax.dtype, device=argmax.device)
    up = torch.where(argmax[..., None] == window, e[..., None], zero)
    side = 2 * POOLED
    up = up.reshape(n, c * FILTERS, POOLED, POOLED, 2, 2)
    up = up.permute(0, 1, 2, 4, 3, 5).reshape(n, c * FILTERS, side, side)
    xg = x.reshape(c, n, HW, HW).transpose(0, 1).reshape(n, c, HW, HW)
    weight = xg.new_empty(1).expand(c * FILTERS, 1, K, K)
    _, dw, db = torch.ops.aten.convolution_backward(
        up, xg, weight, [c * FILTERS], [1, 1], [0, 0], [1, 1], False, [0, 0],
        c, [False, True, True])
    return dw.reshape(c, FILTERS, 1, K, K), db.reshape(c, FILTERS)


# ------------------------------------------------------------------ kernels

def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("csrc/conv_pool.cu")
        lib.cp_forward.argtypes = [_P, _L, _L, _P, _L, _P, _L, _P, _P, _I,
                                   _I, _I, _P]
        lib.cp_forward.restype = _I
        lib.cp_weight_grad.argtypes = [_P, _L, _L, _P, _P, _P, _L, _L, _P,
                                       _P, _P, _P, _I, _I, _I, _I, _P]
        lib.cp_weight_grad.restype = _I
        lib.cp_wgrad_slots.argtypes = [_I, ctypes.POINTER(_I)]
        lib.cp_wgrad_slots.restype = _I
        lib.cp_kernel_attributes.argtypes = [_I, _I, ctypes.POINTER(_I),
                                             ctypes.POINTER(_I)]
        lib.cp_kernel_attributes.restype = _I
        _lib = lib
    return _lib


def kernel_attributes(which: str) -> dict[str, int]:
    """The compiled kernel ``which`` ("fwd" or "wgrad"), from
    ``cudaFuncGetAttributes`` on the current device: registers a thread and
    local memory a thread (bytes: spills)."""
    regs, local = _I(), _I()
    err = _load().cp_kernel_attributes(
        ("fwd", "wgrad").index(which), torch.cuda.current_device(),
        ctypes.byref(regs), ctypes.byref(local))
    build.raise_on(err, "cp_kernel_attributes")
    return {"regs": regs.value, "local_bytes": local.value}


def _blocks(t: torch.Tensor, lead: int) -> torch.Tensor:
    """``t`` with its dimensions after the ``lead`` first flattened into
    one of stride 1 (the kernels take any strides for the leading ones),
    copied only where they are not one contiguous block."""
    t = t.flatten(lead)
    return t if t.stride(lead) == 1 else t.contiguous()


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")


def kernel_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """:func:`forward` on the card: one launch of ``conv_relu_pool_fwd``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"conv_relu_pool_fwd: x must be a CUDA tensor, got "
                         f"{dev}")
    c, n = x.shape[:2]
    _check("conv_relu_pool_fwd x", x, (c, n, 1, HW, HW), torch.float32, dev)
    _check("conv_relu_pool_fwd w", w, (c, FILTERS, 1, K, K), torch.float32,
           dev)
    _check("conv_relu_pool_fwd b", b, (c, FILTERS), torch.float32, dev)
    x, w, b = _blocks(x, 2), _blocks(w, 1), _blocks(b, 1)
    shape = (n, c, FILTERS, POOLED, POOLED)
    y = torch.empty(shape, dtype=torch.float32, device=dev)
    argmax = torch.empty(shape, dtype=torch.uint8, device=dev)
    if y.numel() == 0:
        return y, argmax
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _load().cp_forward(x.data_ptr(), x.stride(0), x.stride(1),
                             w.data_ptr(), w.stride(0), b.data_ptr(),
                             b.stride(0), y.data_ptr(), argmax.data_ptr(), c,
                             n, dev.index, stream)
    build.raise_on(err, "conv_relu_pool_fwd")
    LAUNCHES["conv_relu_pool_fwd"] += 1
    return y, argmax


def wgrad_splits(c: int, n: int, slots: int) -> int:
    """The runs the weight gradient splits each client's B images into: as
    many as keep C x splits CTAs within the ``slots`` the card holds at
    once, at most one an image."""
    return max(1, min(n, slots // c))


def _tickets(device: torch.device, stream: int, count: int) -> torch.Tensor:
    t = _TICKETS.get((device.index, stream))
    if t is None or t.numel() < count:
        t = _TICKETS[(device.index, stream)] = torch.zeros(
            count, dtype=torch.int32, device=device)
    return t


def kernel_weight_grad(g: torch.Tensor, argmax: torch.Tensor,
                       y: torch.Tensor, x: torch.Tensor):
    """:func:`weight_grad` on the card: one launch of
    ``conv_relu_pool_wgrad``."""
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"conv_relu_pool_wgrad: g must be a CUDA tensor, "
                         f"got {dev}")
    n, c = g.shape[:2]
    shape = (n, c, FILTERS, POOLED, POOLED)
    _check("conv_relu_pool_wgrad g", g, shape, torch.float32, dev)
    _check("conv_relu_pool_wgrad argmax", argmax, shape, torch.uint8, dev)
    _check("conv_relu_pool_wgrad y", y, shape, torch.float32, dev)
    _check("conv_relu_pool_wgrad x", x, (c, n, 1, HW, HW), torch.float32, dev)
    g, x = _blocks(g, 2), _blocks(x, 2)
    argmax, y = argmax.contiguous(), y.contiguous()
    dw = torch.empty((c, FILTERS, 1, K, K), dtype=torch.float32, device=dev)
    db = torch.empty((c, FILTERS), dtype=torch.float32, device=dev)
    if c == 0:
        return dw, db
    lib = _load()
    slots = _SLOTS.get(dev.index)
    if slots is None:
        out = _I()
        build.raise_on(lib.cp_wgrad_slots(dev.index, ctypes.byref(out)),
                       "cp_wgrad_slots")
        slots = _SLOTS[dev.index] = out.value
    splits = wgrad_splits(c, n, slots)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _tickets(dev, stream, c)
    partials = torch.empty((c * splits * FILTERS * (K * K + 1)
                            if splits > 1 else 1,),
                           dtype=torch.float32, device=dev)
    err = lib.cp_weight_grad(g.data_ptr(), g.stride(1), g.stride(0),
                             argmax.data_ptr(), y.data_ptr(), x.data_ptr(),
                             x.stride(0), x.stride(1), dw.data_ptr(),
                             db.data_ptr(), partials.data_ptr(),
                             tickets.data_ptr(), c, n, splits, dev.index,
                             stream)
    build.raise_on(err, "conv_relu_pool_wgrad")
    LAUNCHES["conv_relu_pool_wgrad"] += 1
    return dw, db


# ----------------------------------------------------------------- dispatch

def forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The block over C clients: x (C, B, 1, 28, 28), w (C, 32, 1, 5, 5),
    b (C, 32) -> y, argmax (B, C, 32, 12, 12): the kernel on the card, the
    plain version elsewhere."""
    if _on_card(x):
        return kernel_forward(x, w, b)
    return plain_forward(x, w, b)


def weight_grad(g: torch.Tensor, argmax: torch.Tensor, y: torch.Tensor,
                x: torch.Tensor):
    """dW (C, 32, 1, 5, 5) and db (C, 32) of the block from the gradient
    ``g`` of y (B, C, 32, 12, 12): the kernel on the card, the plain
    version elsewhere."""
    if _on_card(g):
        return kernel_weight_grad(g, argmax, y, x)
    return plain_weight_grad(g, argmax, y, x)


def _logical_dim(t: torch.Tensor, bdim: int | None) -> int:
    return t.dim() - (bdim is not None)


def _fold(t: torch.Tensor, bdim: int | None, n: int, dim: int,
          batched: bool) -> torch.Tensor:
    """A vmap operand with its vmap dimension (``bdim``; None: expand it to
    ``n``) folded into the client dimension ``dim`` (made first if the
    logical operand has none)."""
    if bdim is None:
        t = t.unsqueeze(0).expand(n, *t.shape)
        bdim = 0
    t = t.movedim(bdim, dim)
    return t.flatten(dim, dim + 1) if batched else t


def _unfold(t: torch.Tensor, n: int, dim: int, batched: bool):
    """The client dimension ``dim`` split back into (vmap, clients)."""
    return t.unflatten(dim, (n, -1)) if batched else t


def forward_cost(x, w, b) -> tuple[int, int, int]:
    """(FLOPs, bytes, peak bytes) of the forward operator for the dry-run's
    counter: the FLOPs its plain body's convolution counts (25 taps at each
    unpooled position), the bytes its kernel moves (x, w and b read, y and
    the argmax written) and y and the argmax as its peak."""
    imgs = x.shape[0] * x.shape[1]
    out = imgs * FILTERS * POOLED * POOLED * 5
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, b))
    return 2 * imgs * FILTERS * K * K * (2 * POOLED) ** 2, nbytes + out, out


def weight_grad_cost(g, argmax, y, x) -> tuple[int, int, int]:
    """(FLOPs, bytes, peak bytes) of the weight-gradient operator for the
    dry-run's counter: the FLOPs its plain body's convolution counts, the
    bytes its kernel moves (the four inputs read, dW and db written) and dW
    and db as its peak."""
    imgs = x.shape[0] * x.shape[1]
    out = x.shape[0] * FILTERS * (K * K + 1) * 4
    nbytes = sum(t.numel() * t.element_size() for t in (g, argmax, y, x))
    return 2 * imgs * FILTERS * K * K * (2 * POOLED) ** 2, nbytes + out, out


# Both directions are operators of the dispatcher, client-batched, with
# their plain versions as CompositeExplicitAutograd kernels.  The dry-run's
# counter counts each as one op (``launch.analysis.BODY_COSTS``), so a fake
# trace and a real run on the card count alike.  The weight gradient is not
# an autograd.Function: the backward calls it where functorch's grad
# transform is still active, and an operator with no autograd kernel passes
# that level in C++, where a Function would take a second trip through
# functorch's Python machinery (~1 ms of host time a vmapped step on the
# card's host).  It has no derivative.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("conv_relu_pool_fwd(Tensor x, Tensor w, Tensor b) "
            "-> (Tensor, Tensor)")
_LIB.impl("conv_relu_pool_fwd", forward, "CompositeExplicitAutograd")
_LIB.define("conv_relu_pool_wgrad(Tensor g, Tensor argmax, Tensor y, "
            "Tensor x) -> (Tensor, Tensor)")
_LIB.impl("conv_relu_pool_wgrad", weight_grad, "CompositeExplicitAutograd")


def _weight_grad(g, argmax, y, x):
    """The weight gradient, batched (x (C, B, 1, 28, 28) -> dW (C, ...)) or
    not (x (B, 1, 28, 28) -> dW (32, 1, 5, 5)), as the forward was called."""
    if x.dim() == 5:
        return torch.ops.repro_torch.conv_relu_pool_wgrad(g, argmax, y, x)
    dw, db = torch.ops.repro_torch.conv_relu_pool_wgrad(
        g[:, None], argmax[:, None], y[:, None], x[None])
    return dw[0], db[0]


def _weight_grad_vmap(info, in_dims, g, argmax, y, x):
    """The operator's vmap rule: the vmap dimension folded into the clients
    (the operator is client-batched)."""
    n = info.batch_size
    args = [_fold(t, d, n, dim, True) for t, d, dim in
            zip((g, argmax, y, x), in_dims, (1, 1, 1, 0))]
    dw, db = torch.ops.repro_torch.conv_relu_pool_wgrad(*args)
    return (_unfold(dw, n, 0, True), _unfold(db, n, 0, True)), (0, 0)


torch.library.register_vmap("repro_torch::conv_relu_pool_wgrad",
                            _weight_grad_vmap)


class _ConvReluPool(torch.autograd.Function):
    """(x, w, b) -> (y, argmax): unbatched, x (B, 1, 28, 28) -> (B, 32, 12,
    12), or batched, x (C, B, 1, 28, 28) -> (B, C, 32, 12, 12)."""

    @staticmethod
    def forward(x, w, b):
        if x.dim() == 5:
            return torch.ops.repro_torch.conv_relu_pool_fwd(x, w, b)
        y, argmax = torch.ops.repro_torch.conv_relu_pool_fwd(
            x[None], w[None], b[None])
        return y[:, 0], argmax[:, 0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, _, _ = inputs
        y, argmax = output
        if ctx.needs_input_grad[0]:
            raise ValueError("conv_relu_pool: x must not require grad (the "
                             "block computes no input gradient)")
        ctx.mark_non_differentiable(argmax)
        ctx.save_for_backward(x, y, argmax)

    @staticmethod
    def backward(ctx, g, _):
        x, y, argmax = ctx.saved_tensors
        dw, db = _weight_grad(g, argmax, y, x)
        return None, dw, db

    @staticmethod
    def vmap(info, in_dims, x, w, b):
        n = info.batch_size
        batched = _logical_dim(x, in_dims[0]) == 5
        args = [_fold(t, d, n, 0, batched) for t, d in zip((x, w, b), in_dims)]
        y, argmax = _ConvReluPool.apply(*args)
        return ((_unfold(y, n, 1, batched), _unfold(argmax, n, 1, batched)),
                (1, 1))


def conv_relu_pool(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """``max_pool2d(relu(conv2d(x, w, b)), 2)`` for the CNN's conv1: x
    (B, 1, 28, 28) f32, w (32, 1, 5, 5), b (32,) -> (B, 32, 12, 12).
    Differentiable in w and b, not in x; one client-batched call each way
    under ``torch.func.vmap``."""
    if x.dim() != 4 or tuple(x.shape[1:]) != (1, HW, HW) or \
            tuple(w.shape) != (FILTERS, 1, K, K) or \
            tuple(b.shape) != (FILTERS,):
        raise ValueError(f"conv_relu_pool: expected x (B, 1, {HW}, {HW}), w "
                         f"({FILTERS}, 1, {K}, {K}), b ({FILTERS},); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    return _ConvReluPool.apply(x, w, b)[0]
