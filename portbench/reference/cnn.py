"""The paper's MNIST CNN (§IV.D) and its clients' local SGD, in plain
PyTorch f32, written from the paper and McMahan et al. 2017
(arXiv:1602.05629): conv 32@5x5, ReLU, 2x2 max-pool, conv 64@5x5, ReLU,
2x2 max-pool, dense 512, ReLU, dense 10; valid padding, so D = 582,026.

Parameters are a dict in PyTorch layouts (OIHW convolutions, (out, in)
dense weights); :data:`FLAT` is the column order of the client matrix W
(each leaf in the reference layout: HWIO convolutions, (in, out) dense
weights, leaves in sorted order).  :func:`initial` makes θ0 from the seed
(He-normal weights, zero biases), which the benchmark hands to both sides.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.harness import traffic

#: (name, shape, fan-in of a He-normal weight; None for a zero bias)
PARAMS = (("conv1.bias", (32,), None), ("conv1.weight", (32, 1, 5, 5), 25),
          ("conv2.bias", (64,), None), ("conv2.weight", (64, 32, 5, 5), 800),
          ("fc1.bias", (512,), None), ("fc1.weight", (512, 1024), 1024),
          ("fc2.bias", (10,), None), ("fc2.weight", (10, 512), 512))

#: W's columns: (leaf, permutation from the PyTorch layout to W's layout)
FLAT = (("conv1.bias", None), ("conv1.weight", (2, 3, 1, 0)),
        ("conv2.bias", None), ("conv2.weight", (2, 3, 1, 0)),
        ("fc1.bias", None), ("fc1.weight", (1, 0)),
        ("fc2.bias", None), ("fc2.weight", (1, 0)))


def initial(seed: int, device) -> dict[str, torch.Tensor]:
    """θ0 from the seed, f32 on ``device``."""
    z = traffic.NormalStream(traffic.generator(seed, "weights", device),
                             sum(math.prod(s) for _, s, f in PARAMS if f))
    return {name: (torch.zeros(shape, device=device) if fan is None
                   else z.take(math.prod(shape)).view(shape)
                   * (2.0 / fan) ** 0.5)
            for name, shape, fan in PARAMS}


def forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, 28, 28, 1) NHWC -> logits (B, 10); the flatten in (h, w, c)
    order."""
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(F.relu(F.conv2d(h, p["conv1.weight"], p["conv1.bias"])), 2)
    h = F.max_pool2d(F.relu(F.conv2d(h, p["conv2.weight"], p["conv2.bias"])), 2)
    h = h.permute(0, 2, 3, 1).flatten(1)
    h = F.relu(h @ p["fc1.weight"].T + p["fc1.bias"])
    return h @ p["fc2.weight"].T + p["fc2.bias"]


def loss(p: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(forward(p, x), y)


def client_update(theta: dict, x: torch.Tensor, y: torch.Tensor,
                  perms: torch.Tensor, batch: int, lr: float,
                  keep: float = 1.0) -> dict:
    """One client's local SGD from ``theta``: for each epoch e, the samples
    in the order ``perms[e]``, ``n // batch`` steps of ``batch`` and one
    of the rest where ``batch`` does not divide n; each step the mean
    cross-entropy's gradient times ``lr``.  ``keep`` < 1 plants a fault:
    each step's loss is the mean over that share of its batch."""
    p = {k: v.detach().clone().requires_grad_() for k, v in theta.items()}
    n = x.shape[0]
    for perm in perms:
        for s in range(0, n, batch):
            idx = perm[s:s + batch]
            idx = idx[:max(1, int(len(idx) * keep))]
            g = torch.autograd.grad(loss(p, x[idx], y[idx]), list(p.values()))
            with torch.no_grad():
                p = {k: (v - lr * gk).requires_grad_()
                     for (k, v), gk in zip(p.items(), g)}
    return {k: v.detach() for k, v in p.items()}


def flatten(p: dict) -> torch.Tensor:
    """One model as a row of W."""
    return torch.cat([(p[k] if perm is None else p[k].permute(perm))
                      .reshape(-1) for k, perm in FLAT])


def unflatten(row: torch.Tensor) -> dict:
    """A row of W as a parameter dict (PyTorch layouts)."""
    shapes = dict((k, s) for k, s, _ in PARAMS)
    out, off = {}, 0
    for k, perm in FLAT:
        shape = shapes[k]
        n = math.prod(shape)
        if perm is None:
            out[k] = row[off:off + n].view(shape)
        else:
            ref_shape = tuple(shape[i] for i in perm)
            inv = [perm.index(i) for i in range(len(perm))]
            out[k] = row[off:off + n].view(ref_shape).permute(inv)
        off += n
    return out

