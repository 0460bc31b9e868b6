"""The CNN's first block as one client-batched op (``kernels/conv_pool.py``).

On the CPU: the plain client-batched forward and weight gradient against
each client's ``F.conv2d`` -> ``relu`` -> ``max_pool2d`` with autograd, on
data whose sums are exact in f32 (inputs on a grid of 1/4, weights and
gradients of 1/8), so that both agree bit for bit and windows meet ties,
all-negative maxima (no gradient) and exact zeros; the op under
``vmap(grad_and_value(...))`` with x shared (in-dim None) or per client and
the gradient arriving with its vmap dimension first or second; the CNN's
loss gradients through the op against the module's former path
(``max_pool2d(relu(conv1(x)), 2)``), within f32 round-off.

On the card (marked ``cuda``, skipped without one; this file imports no
JAX, so it runs with ``--noconftest``): both kernels against the plain
versions at C in {1, 7, 100} clients and B in {10, 50} images and at one
client of 10,000 (the evaluation's call), bit for bit on the exact grid and within 2e-6 of the max on normal data (the
argmax where the window's two largest differ by more than that; the weight
gradient's sums of B x 144 products within 2e-6 x sqrt(B / 50)); repeats
of the weight gradient equal bit for bit; a 2-round ``Federation.run``
launching the forward once a vmapped SGD step and an evaluation and the
weight gradient once a step; a CUDA graph of ``cnn.apply``; and the
wrapper's refusals.

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_conv_pool.py
"""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import conv_pool as cp
from repro_torch.models import cnn
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()


def _grid(shape, step: float, lo: int, hi: int, gen) -> torch.Tensor:
    """Values step * k, k uniform in [lo, hi]: sums of their products stay
    exact in f32."""
    return torch.randint(lo, hi + 1, shape, generator=gen).float() * step


def _exact(c: int, n: int, seed: int = 0, device="cpu"):
    """x (C, B, 1, 28, 28) on a grid of 1/4, w and b on a grid of 1/8: the
    pre-activations are exact, with ties, zeros and negative windows."""
    gen = torch.Generator().manual_seed(seed)
    x = _grid((c, n, 1, 28, 28), 0.25, -2, 2, gen)
    w = _grid((c, 32, 1, 5, 5), 0.125, -2, 2, gen)
    b = _grid((c, 32), 0.125, -2, 2, gen)
    return x.to(device), w.to(device), b.to(device)


def _per_client(x, w, b):
    """Each client's block with autograd, as the module ran it: y (B, C, 32,
    12, 12) and the pooled indices turned into window indices."""
    ys, idxs = [], []
    for i in range(x.shape[0]):
        h = F.relu(F.conv2d(x[i], w[i], b[i]))
        y, idx = F.max_pool2d(h, 2, return_indices=True)
        ys.append(y)
        idxs.append(((idx // 24) % 2 * 2 + idx % 2).to(torch.uint8))
    return torch.stack(ys, 1), torch.stack(idxs, 1)


@pytest.mark.parametrize("c,n", [(1, 3), (3, 5), (4, 1)])
def test_plain_forward_matches_per_client_block(c, n):
    x, w, b = _exact(c, n, seed=c * 10 + n)
    y, argmax = cp.plain_forward(x, w, b)
    want_y, want_arg = _per_client(x, w, b)
    assert y.shape == argmax.shape == (n, c, 32, 12, 12)
    assert argmax.dtype == torch.uint8
    assert torch.equal(y, want_y)
    assert torch.equal(argmax, want_arg)
    # the grid meets what the argmax must get right
    pre = torch.stack([F.conv2d(x[i], w[i], b[i]) for i in range(c)], 1)
    win = pre.reshape(n, c, 32, 12, 2, 12, 2)
    top2 = win.permute(0, 1, 2, 3, 5, 4, 6).reshape(-1, 4).topk(2).values
    assert bool(((top2[:, 0] == top2[:, 1]) & (top2[:, 0] > 0)).any())
    assert bool((y == 0).any()) and bool((pre == 0).any())


@pytest.mark.parametrize("c,n", [(1, 3), (3, 5)])
def test_plain_weight_grad_matches_autograd(c, n):
    x, w, b = _exact(c, n, seed=7 + c)
    g = _grid((n, c, 32, 12, 12), 0.125, -4, 4,
              torch.Generator().manual_seed(1))
    y, argmax = cp.plain_forward(x, w, b)
    dw, db = cp.plain_weight_grad(g, argmax, y, x)
    for i in range(c):
        wi = w[i].clone().requires_grad_()
        bi = b[i].clone().requires_grad_()
        out = F.max_pool2d(F.relu(F.conv2d(x[i], wi, bi)), 2)
        want_w, want_b = torch.autograd.grad((out * g[:, i]).sum(), (wi, bi))
        assert torch.equal(dw[i], want_w)
        assert torch.equal(db[i], want_b)
    # all-negative windows carry no gradient: a gradient only there gives 0
    dead = torch.where(y == 0, g, torch.zeros(()))
    dw0, db0 = cp.plain_weight_grad(dead, argmax, y, x)
    assert not bool(dw0.any()) and not bool(db0.any())


def test_plain_weight_grad_of_no_images_is_zero():
    x, w, b = _exact(2, 0)
    y, argmax = cp.plain_forward(x, w, b)
    dw, db = cp.plain_weight_grad(torch.zeros_like(y), argmax, y, x)
    assert dw.shape == (2, 32, 1, 5, 5) and not bool(dw.any())
    assert db.shape == (2, 32) and not bool(db.any())


def _old_block(x, w, b):
    return F.max_pool2d(F.relu(F.conv2d(x, w, b)), 2)


def _loss(block, head):
    """A loss over the block's output through a head: a fixed linear map
    (its gradient reaches the block with the vmap dimension first), or a
    per-client convolution as conv2 (the vmap dimension second)."""
    def loss(w, b, x, h):
        y = block(x, w, b)
        if head == "linear":
            return (y.flatten(1) @ h).square().mean()
        return F.conv2d(y, h).square().mean()
    return loss


class _Calls(TorchDispatchMode):
    """Records the block's operators as they run on the physical tensors:
    the forward with its client count, the weight gradient with the layout
    of the client-batched gradient (B, C, ...) in memory."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.repro_torch.conv_relu_pool_fwd.default:
            self.seen.append(("fwd", args[0].shape[0]))
        elif func is torch.ops.repro_torch.conv_relu_pool_wgrad.default:
            g = args[0]
            self.seen.append(("wgrad", "images first"
                              if g.stride(0) > g.stride(1)
                              else "clients first"))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("x_dim,w_dim", [(0, 0), (0, None), (None, 0)])
@pytest.mark.parametrize("head,g_dim", [("linear", 0), ("conv", 1)])
def test_op_under_vmap_grad_and_value(x_dim, w_dim, head, g_dim):
    """One client-batched call each way under ``vmap(grad_and_value)``,
    whatever the in-dims of x, the weights and the gradient (its vmap
    dimension first, or second as conv2's gradient comes)."""
    c, n = 4, 6
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((c, n, 1, 28, 28), generator=gen)
    w = torch.randn((c, 32, 1, 5, 5), generator=gen) * 0.2
    b = torch.randn((c, 32), generator=gen) * 0.1
    h = torch.randn((32 * 144, 3), generator=gen) if head == "linear" \
        else torch.randn((c, 8, 32, 5, 5), generator=gen)
    args = (w if w_dim == 0 else w[0], b if w_dim == 0 else b[0],
            x if x_dim == 0 else x[0], h)
    in_dims = (w_dim, w_dim, x_dim, None if head == "linear" else 0)

    with _Calls() as calls:
        (gw, gb), loss = vmap(grad_and_value(_loss(cp.conv_relu_pool, head),
                                             argnums=(0, 1)),
                              in_dims=in_dims)(*args)
    (ow, ob), oloss = vmap(grad_and_value(_loss(_old_block, head),
                                          argnums=(0, 1)),
                           in_dims=in_dims)(*args)
    layout = "images first" if g_dim == 1 else "clients first"
    assert calls.seen == [("fwd", c), ("wgrad", layout)]
    for got, want in ((loss, oloss), (gw, ow), (gb, ob)):
        assert got.shape == want.shape
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 2e-6 * scale


def test_op_refuses_an_input_that_requires_grad_and_other_shapes():
    x, w, b = _exact(1, 2)
    with pytest.raises(ValueError, match="must not require grad"):
        cp.conv_relu_pool(x[0].requires_grad_(), w[0], b[0])
    with pytest.raises(ValueError, match="expected x"):
        cp.conv_relu_pool(x[0].expand(2, 2, 28, 28), w[0], b[0])
    with pytest.raises(ValueError, match="expected x"):
        cp.conv_relu_pool(x[0], w[0, :16], b[0, :16])
    with pytest.raises(ValueError, match="expected x"):
        cp.conv_relu_pool(x[0, :, :, :24, :24], w[0], b[0])


def test_meta_and_fake_tensors_take_the_plain_version():
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = dict(cp.LAUNCHES)
    y = cp.conv_relu_pool(torch.empty((5, 1, 28, 28), device="meta"),
                          torch.empty((32, 1, 5, 5), device="meta"),
                          torch.empty((32,), device="meta"))
    assert y.shape == (5, 32, 12, 12) and y.device.type == "meta"
    with FakeTensorMode():
        x = torch.empty((3, 7, 1, 28, 28))
        y, argmax = cp.forward(x, torch.empty((3, 32, 1, 5, 5)),
                               torch.empty((3, 32)))
        dw, db = cp.weight_grad(y, argmax, y, x)
    assert y.shape == (7, 3, 32, 12, 12) and dw.shape == (3, 32, 1, 5, 5)
    assert cp.LAUNCHES == before


def _old_forward(params, x):
    """The module's former forward: conv1, ReLU and pool as three ops."""
    p = params
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(F.relu(F.conv2d(h, p["conv1.weight"], p["conv1.bias"])),
                     2)
    h = F.max_pool2d(F.relu(F.conv2d(h, p["conv2.weight"],
                                     p["conv2.bias"])), 2)
    h = h.permute(0, 2, 3, 1).flatten(1)
    h = F.relu(F.linear(h, p["fc1.weight"], p["fc1.bias"]))
    return F.linear(h, p["fc2.weight"], p["fc2.bias"])


def test_cnn_loss_gradients_match_the_former_path():
    gen = torch.Generator().manual_seed(4)
    params = cnn.init(gen)
    c, n = 3, 10
    x = torch.rand((c, n, 28, 28, 1), generator=gen)
    y = torch.randint(0, 10, (c, n), generator=gen)
    stacked = {k: v[None] + 0.01 * torch.randn((c,) + v.shape, generator=gen)
               for k, v in params.items()}

    def old_loss(p, batch):
        return F.cross_entropy(_old_forward(p, batch["x"]), batch["y"])

    batch = {"x": x, "y": y}
    got = vmap(grad_and_value(cnn.loss_fn))(stacked, batch)
    want = vmap(grad_and_value(old_loss))(stacked, batch)
    assert float((got[1] - want[1]).abs().max()) <= 1e-6 * float(
        want[1].abs().max())
    for k in params:
        scale = float(want[0][k].abs().max())
        assert float((got[0][k] - want[0][k]).abs().max()) <= 1e-5 * scale, k
    # unbatched, as the evaluation and serving call it
    assert torch.allclose(cnn.apply(params, x[0]), _old_forward(params, x[0]),
                          rtol=0, atol=1e-5)


def test_wgrad_splits_fill_the_card():
    """The weight gradient splits a client's images into runs only until
    C x splits CTAs fill the card once, one run an image at most."""
    slots = 528
    assert cp.wgrad_splits(100, 50, slots) == 5
    assert cp.wgrad_splits(1000, 50, slots) == 1
    assert cp.wgrad_splits(1, 10_000, slots) == 528
    assert cp.wgrad_splits(1, 10, slots) == 10
    assert cp.wgrad_splits(3, 0, slots) == 1


def test_wrapper_constants_are_the_kernels():
    """The block's shape in csrc/conv_pool.cu is the wrapper's."""
    import re
    from pathlib import Path

    src = (Path(cp.__file__).parent / "csrc" / "conv_pool.cu").read_text()
    const = {m[0]: int(m[1]) for m in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kHW"], const["kF"], const["kK"], const["kP"]) == \
        (cp.HW, cp.FILTERS, cp.K, cp.POOLED)


# ----------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = tf32


#: (clients, images a client) the kernels are held at
CARD_SHAPES = [(1, 10), (1, 50), (1, 10_000), (7, 10), (7, 50), (100, 10),
               (100, 50)]
#: kernel vs plain on normal data, max abs error / max |plain|: both sum in
#: f32, in other orders (25 taps; B x 144 positions for the gradient)
CARD_TOL = 2e-6


def _plain_on_cpu(fn, *args):
    """The plain version on the CPU (direct f32 convolutions, where cuDNN
    may pick Winograd), its results moved back to the card."""
    out = fn(*(t.cpu() for t in args))
    return tuple(t.to(args[0].device) for t in out)


@pytest.mark.cuda
@pytest.mark.parametrize("c,n", CARD_SHAPES)
def test_cuda_kernels_match_plain_on_the_exact_grid(card, c, n):
    x, w, b = _exact(c, n, seed=c + n, device=card)
    y, argmax = cp.kernel_forward(x, w, b)
    want_y, want_arg = _plain_on_cpu(cp.plain_forward, x, w, b)
    assert torch.equal(y, want_y)
    assert torch.equal(argmax, want_arg)
    g = _grid((n, c, 32, 12, 12), 0.125, -4, 4,
              torch.Generator().manual_seed(2)).to(card)
    dw, db = cp.kernel_weight_grad(g, argmax, y, x)
    want_w, want_b = _plain_on_cpu(cp.plain_weight_grad, g, want_arg,
                                   want_y, x)
    assert torch.equal(dw, want_w) and torch.equal(db, want_b)


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("c,n", CARD_SHAPES)
def test_cuda_kernels_match_plain_on_normal_data(card, c, n):
    gen = torch.Generator(device=card).manual_seed(c * 100 + n)
    x = torch.rand((c, n, 1, 28, 28), device=card, generator=gen)
    w = torch.randn((c, 32, 1, 5, 5), device=card, generator=gen) * 0.3
    b = torch.randn((c, 32), device=card, generator=gen) * 0.1
    y, argmax = cp.kernel_forward(x, w, b)
    want_y, want_arg = _plain_on_cpu(cp.plain_forward, x, w, b)
    assert _rel(y, want_y) <= CARD_TOL
    # the argmax wherever the window's two largest part by more than that
    pre = F.conv2d(x.cpu().transpose(0, 1).reshape(n, c, 28, 28),
                   w.cpu().reshape(c * 32, 1, 5, 5), b.cpu().reshape(-1),
                   groups=c)
    win = F.relu(pre).reshape(n, c, 32, 12, 2, 12, 2).permute(
        0, 1, 2, 3, 5, 4, 6).reshape(n, c, 32, 12, 12, 4)
    top2 = win.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] >
             CARD_TOL * float(want_y.abs().max())).to(card)
    assert torch.equal(argmax[clear], want_arg[clear])
    assert float(clear.float().mean()) > 0.5
    g = torch.randn((n, c, 32, 12, 12), device=card, generator=gen)
    dw, db = cp.kernel_weight_grad(g, want_arg, want_y, x)
    want_w, want_b = _plain_on_cpu(cp.plain_weight_grad, g, want_arg,
                                   want_y, x)
    # each output sums B x 144 products, in f32 along another order: its
    # round-off grows as the square root of that length
    tol = CARD_TOL * max(1.0, (n / 50) ** 0.5)
    assert _rel(dw, want_w) <= tol and _rel(db, want_b) <= tol
    # no atomics: a repeat is bit-identical, also from a gradient laid out
    # client-major (the kernel reads any image and client strides)
    again = cp.kernel_weight_grad(g.transpose(0, 1).contiguous()
                                  .transpose(0, 1), want_arg, want_y, x)
    assert torch.equal(again[0], dw) and torch.equal(again[1], db)


@pytest.mark.cuda
def test_cuda_kernels_take_a_shared_batch_and_strided_weights(card):
    """x with client stride 0 (one batch for every client) and weights
    broadcast from one client, as ``vmap`` hands them at a first step."""
    c, n = 5, 9
    x, w, b = _exact(1, n, seed=3, device=card)
    xs, ws, bs = (t.expand(c, *t.shape[1:]) for t in (x, w, b))
    y, argmax = cp.kernel_forward(xs, ws, bs)
    want = _plain_on_cpu(cp.plain_forward, xs, ws, bs)
    assert torch.equal(y, want[0]) and torch.equal(argmax, want[1])
    g = torch.ones_like(y)
    got = cp.kernel_weight_grad(g, argmax, y, xs)
    plain = _plain_on_cpu(cp.plain_weight_grad, g, argmax, y, xs)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


@pytest.mark.cuda
def test_cuda_kernels_do_not_spill(card):
    for which in ("fwd", "wgrad"):
        attrs = cp.kernel_attributes(which)
        assert attrs["local_bytes"] == 0, (which, attrs)


@pytest.mark.cuda
def test_cuda_federation_launches_two_kernels_a_step(card):
    """A 2-round ``Federation.run`` of the CNN: the forward once a vmapped
    SGD step and once an evaluation, the weight gradient once a step."""
    from repro_torch.core.client import ClientConfig
    from repro_torch.core.server import Federation, FederationConfig
    from repro_torch.kernels import ops
    from repro_torch.models import zoo

    model = zoo.make_model("cnn")
    gen = torch.Generator().manual_seed(0)
    n_clients, n_local, bs, epochs, rounds = 4, 30, 10, 2, 2
    data = {"x": torch.rand((n_clients, n_local, 28, 28, 1),
                            generator=gen).to(card),
            "y": torch.randint(0, 10, (n_clients, n_local),
                               generator=gen).to(card)}
    test_x, test_y = data["x"][0], data["y"][0]
    evals = []

    def eval_fn(p):
        evals.append(1)
        return model.accuracy(p, test_x, test_y)

    cfg = FederationConfig(n_clients=n_clients, n_coalitions=2,
                           rounds=rounds, backend="cuda",
                           client=ClientConfig(epochs=epochs, batch_size=bs))
    params = {k: v.to(card) for k, v in model.init(gen).items()}
    ops.reset_launch_counts()
    Federation(model, eval_fn, cfg).run(params, data, generator=gen)
    torch.cuda.synchronize()
    steps = rounds * epochs * (n_local // bs)
    counts = ops.launch_counts()
    assert counts["conv_relu_pool_wgrad"] == steps
    assert counts["conv_relu_pool_fwd"] == steps + len(evals)
    assert len(evals) >= rounds


@pytest.mark.cuda
def test_cuda_graph_of_cnn_apply(card):
    gen = torch.Generator().manual_seed(1)
    params = {k: v.to(card) for k, v in cnn.init(gen).items()}
    x = torch.rand((64, 28, 28, 1), generator=gen).to(card)
    eager = cnn.apply(params, x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cnn.apply(params, x)          # warm-up: the build and first calls
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cnn.apply(params, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x.copy_(torch.rand((64, 28, 28, 1), generator=gen).to(card))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, cnn.apply(params, x))


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_it_does_not_take(card):
    x, w, b = _exact(2, 3, device=card)
    with pytest.raises(TypeError, match="float32"):
        cp.kernel_forward(x.double(), w, b)
    with pytest.raises(TypeError, match="float32"):
        cp.conv_relu_pool(x[0].half(), w[0].half(), b[0].half())
    with pytest.raises(ValueError, match="expected shape"):
        cp.kernel_forward(x, w[:, :16], b)
    with pytest.raises(ValueError, match="expected a tensor on"):
        cp.kernel_forward(x, w.cpu(), b)
    with pytest.raises(ValueError, match="expected x"):
        cp.conv_relu_pool(x[0, :, :, :20], w[0], b[0])
    y, argmax = cp.kernel_forward(x, w, b)
    with pytest.raises(TypeError, match="uint8"):
        cp.kernel_weight_grad(y, argmax.long(), y, x)
    with pytest.raises(ValueError, match="expected shape"):
        cp.kernel_weight_grad(y[:, :1], argmax, y, x)
