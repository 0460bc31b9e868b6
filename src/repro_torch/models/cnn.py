"""The paper's MNIST CNN (§IV.D) as an ``nn.Module``.

conv1: 32@5x5 + ReLU -> maxpool 2x2/2
conv2: 64@5x5 + ReLU -> maxpool 2x2/2
fc1: 512 + ReLU
fc2: 10 (class logits)

Valid padding: 28 -> 24 -> 12 -> 8 -> 4, so the flattened feature is
4*4*64 = 1024 and D = 582,026.

The first block (conv1, its ReLU and pool) is one client-batched kernel
pair on the card, :func:`repro_torch.kernels.conv_pool.conv_relu_pool`
(differentiable in the weights only: the input is data); conv2 onwards are
torch's.

Inputs are NHWC ``(B, 28, 28, 1)`` as in the reference; the module computes
in NCHW and permutes back to NHWC before the flatten, so ``fc1`` sees the
features in the reference's (h, w, c) order and carried weights give the
reference's logits.  Parameters are a dict ``name -> tensor`` in PyTorch
layouts (OIHW convolutions, (out, in) linears); :data:`REF_LAYOUT` maps each
to its reference leaf and layout.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch.kernels import conv_pool


class CNNConfig(NamedTuple):
    c1: int = 32
    c2: int = 64
    kernel: int = 5
    fc: int = 512
    n_classes: int = 10
    in_hw: int = 28

    def flat(self) -> int:
        spatial = (self.in_hw - self.kernel + 1) // 2     # conv1 + pool
        spatial = (spatial - self.kernel + 1) // 2        # conv2 + pool
        return spatial * spatial * self.c2

    def n_params(self) -> int:
        """Parameter count (582,026 at the defaults)."""
        k2 = self.kernel * self.kernel
        return (k2 * self.c1 + self.c1 + k2 * self.c1 * self.c2 + self.c2
                + self.flat() * self.fc + self.fc
                + self.fc * self.n_classes + self.n_classes)


#: (module parameter, reference leaf path, permutation from the reference
#: layout to the module's), in the reference's flatten order — sorted keys,
#: as ``jax.tree_util.tree_flatten_with_path`` visits the params dict.
REF_LAYOUT: tuple[tuple[str, str, tuple[int, ...] | None], ...] = (
    ("conv1.bias", "conv1/b", None),
    ("conv1.weight", "conv1/w", (3, 2, 0, 1)),    # HWIO -> OIHW
    ("conv2.bias", "conv2/b", None),
    ("conv2.weight", "conv2/w", (3, 2, 0, 1)),
    ("fc1.bias", "fc1/b", None),
    ("fc1.weight", "fc1/w", (1, 0)),              # (in, out) -> (out, in)
    ("fc2.bias", "fc2/b", None),
    ("fc2.weight", "fc2/w", (1, 0)),
)


class CNN(nn.Module):
    def __init__(self, cfg: CNNConfig = CNNConfig()):
        super().__init__()
        self.conv1 = nn.Conv2d(1, cfg.c1, cfg.kernel)
        self.conv2 = nn.Conv2d(cfg.c1, cfg.c2, cfg.kernel)
        self.fc1 = nn.Linear(cfg.flat(), cfg.fc)
        self.fc2 = nn.Linear(cfg.fc, cfg.n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 28, 28, 1) NHWC -> logits (B, 10)."""
        h = x.permute(0, 3, 1, 2)
        h = conv_pool.conv_relu_pool(h, self.conv1.weight, self.conv1.bias)
        h = F.max_pool2d(F.relu(self.conv2(h)), 2)
        h = h.permute(0, 2, 3, 1).flatten(1)        # NHWC flatten
        h = F.relu(self.fc1(h))
        return self.fc2(h)


#: a parameter-free copy of the module (on the meta device): every call
#: passes the parameters in through ``functional_call``.  Built here, not
#: lazily, because a first call may come inside ``vmap``, which refuses the
#: random initialisation that building a module runs.
with torch.device("meta"):
    _NET = CNN()


def init(generator: torch.Generator,
         device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """He-normal weights and zero biases, drawn from ``generator`` on the CPU.

    Same distribution as ``repro.models.cnn.init``; the draws differ (torch
    cannot reproduce threefry), so parity tests carry the reference's
    weights across with :func:`repro_torch.carry.params_from_jax`.
    """
    cfg = CNNConfig()
    k2 = cfg.kernel * cfg.kernel

    def he(shape, fan_in):
        return (torch.randn(shape, generator=generator)
                * (2.0 / fan_in) ** 0.5).to(device)

    def zeros(n):
        return torch.zeros((n,), device=device)

    return {
        "conv1.bias": zeros(cfg.c1),
        "conv1.weight": he((cfg.c1, 1, cfg.kernel, cfg.kernel), k2),
        "conv2.bias": zeros(cfg.c2),
        "conv2.weight": he((cfg.c2, cfg.c1, cfg.kernel, cfg.kernel),
                           k2 * cfg.c1),
        "fc1.bias": zeros(cfg.fc),
        "fc1.weight": he((cfg.fc, cfg.flat()), cfg.flat()),
        "fc2.bias": zeros(cfg.n_classes),
        "fc2.weight": he((cfg.n_classes, cfg.fc), cfg.fc),
    }


def apply(params: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Logits of ``x`` (B, 28, 28, 1) under ``params`` (default config)."""
    return functional_call(_NET, params, (x,))


def loss_fn(params: dict[str, torch.Tensor], batch: dict) -> torch.Tensor:
    """Mean softmax cross-entropy on a {'x', 'y'} batch."""
    return F.cross_entropy(apply(params, batch["x"]), batch["y"].long())


def accuracy(params: dict[str, torch.Tensor], x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(apply(params, x), dim=-1) == y).float())
