"""The traffic generator: every input of a run, made on the device from
``--seed``.

A traffic file (``traffic/<name>.json``) names its ``kind`` and
parameters; :func:`generator` gives each kind of draw a generator of its own,
seeded from the run's seed and a fixed tag, so one seed always gives the
same inputs whatever else a run draws.

- ``fl_images``: MNIST-shaped digits (28x28, one channel, 10 classes),
  rendered from seven-segment glyphs with integer shifts, stroke intensity
  and Gaussian pixel noise (the construction of the port's
  ``data/synthetic.digits``, drawn on the device), split over clients by
  McMahan et al.'s label shards, plus a test set.
- ``lm_tokens``: Zipf(1.1) token rows with a bigram twist (every odd
  position copies ``(7·prev + 13) mod V`` half of the time; the
  construction of ``data/synthetic.lm_tokens``).
- Weights: :class:`NormalStream` hands out standard normal draws made in
  a few large calls, which the configurations' references scale leaf by
  leaf (:mod:`portbench.reference`).
"""
from __future__ import annotations

import numpy as np
import torch

#: tags of the independent draws of one run
TAGS = {"data": 1, "split": 2, "weights": 3, "rows": 4, "shuffles": 5,
        "check": 6, "warm": 7}


def stream_seed(seed: int, tag: str) -> int:
    """The seed of draw ``tag`` of a run with ``seed`` (any int up to
    2**63; the driver's are larger than 32 bits)."""
    return (int(seed) * 1_000_003 + TAGS[tag]) % (2 ** 63)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, tag))


# --- digits -------------------------------------------------------------------

_SEGMENTS = {0: "ABCDEF", 1: "BC", 2: "ABGED", 3: "ABGCD", 4: "FGBC",
             5: "AFGCD", 6: "AFGECD", 7: "ABC", 8: "ABCDEFG", 9: "ABCFGD"}
_SEG_COORDS = {"A": (1, 2, 1, 11), "B": (2, 11, 10, 11),
               "C": (13, 11, 21, 11), "D": (22, 2, 22, 11),
               "E": (13, 2, 21, 2), "F": (2, 2, 10, 2), "G": (11, 2, 11, 11)}


def glyphs(hw: int = 28) -> np.ndarray:
    """(10, hw, hw) f32 seven-segment digit templates, strokes 3 px wide."""
    out = np.zeros((10, hw, hw), np.float32)
    for digit, segs in _SEGMENTS.items():
        for seg in segs:
            r0, c0, r1, c1 = _SEG_COORDS[seg]
            npts = max(abs(r1 - r0), abs(c1 - c0)) + 1
            rs = np.linspace(r0, r1, npts).round().astype(int) + 2
            cs = np.linspace(c0, c1, npts).round().astype(int) + 7
            for rr, cc in zip(rs, cs):
                out[digit, max(rr - 1, 0):rr + 2, max(cc - 1, 0):cc + 2] = 1.0
    return out


def digits(n: int, gen: torch.Generator, *, noise: float = 0.25,
           max_shift: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` digits on the generator's device: x (n, 28, 28, 1) f32 in
    [0, 1], y (n,) int64."""
    dev = gen.device
    s = 2 * max_shift + 1
    base = torch.from_numpy(glyphs()).to(dev)
    # every template at every (row, column) roll, gathered by index
    rolled = torch.stack([torch.roll(base, (r - max_shift, c - max_shift),
                                     dims=(1, 2))
                          for r in range(s) for c in range(s)], dim=1)
    y = torch.randint(0, 10, (n,), generator=gen, device=dev)
    shift = torch.randint(0, s * s, (n,), generator=gen, device=dev)
    x = rolled[y, shift]
    x = x * (0.6 + 0.4 * torch.rand((n, 1, 1), generator=gen, device=dev))
    x = x + noise * torch.randn(x.shape, generator=gen, device=dev)
    return torch.clamp(x, 0.0, 1.0)[..., None], y


def label_shards(y: torch.Tensor, n_clients: int, per_client: int,
                 n_local: int, gen: torch.Generator) -> torch.Tensor:
    """McMahan et al.'s pathological non-IID split: the samples sorted by
    label, cut into ``n_clients · per_client`` shards of ``n_local /
    per_client``, ``per_client`` random shards a client, each client's
    samples then shuffled.  Returns the (N, n_local) index matrix."""
    n_shards = n_clients * per_client
    size = n_local // per_client
    if size * per_client != n_local or n_shards * size > y.shape[0]:
        raise ValueError(f"{n_clients} clients x {n_local} samples do not "
                         f"split into {per_client} shards of {y.shape[0]}")
    order = torch.argsort(y, stable=True)[:n_shards * size]
    shards = order.view(n_shards, size)[
        torch.randperm(n_shards, generator=gen, device=y.device)]
    idx = shards.reshape(n_clients, n_local)
    mix = torch.argsort(torch.rand(idx.shape, generator=gen,
                                   device=y.device), dim=1)
    return torch.gather(idx, 1, mix)


def fl_images(traffic: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """A federation's data: ``x`` (N, n, 28, 28, 1), ``y`` (N, n) int64,
    ``test_x`` (n_test, 28, 28, 1), ``test_y`` (n_test,)."""
    n, n_local = traffic["n_clients"], traffic["n_local"]
    g = generator(seed, "data", device)
    x, y = digits(n * n_local + traffic["n_test"], g)
    tx, ty = x[n * n_local:], y[n * n_local:]
    x, y = x[:n * n_local], y[:n * n_local]
    idx = label_shards(y, n, traffic["shards_per_client"], n_local,
                       generator(seed, "split", device))
    return {"x": x[idx], "y": y[idx], "test_x": tx.contiguous(),
            "test_y": ty.contiguous()}


# --- LM token rows ------------------------------------------------------------

def lm_rows(n_rows: int, seq: int, vocab: int, seed: int,
            device) -> torch.Tensor:
    """(n_rows, seq) int64 token rows: Zipf(1.1) over the vocabulary with
    the bigram twist on the odd positions."""
    g = generator(seed, "rows", device)
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = ranks ** -1.1
    toks = torch.multinomial((p / p.sum()).float(), n_rows * seq,
                             replacement=True, generator=g).view(n_rows, seq)
    det = (toks[:, :-1:2] * 7 + 13) % vocab
    keep = torch.rand(det.shape, generator=g, device=device) < 0.5
    toks[:, 1::2] = torch.where(keep, det, toks[:, 1::2])
    return toks


# --- weights ------------------------------------------------------------------

class NormalStream:
    """``total`` standard normal f32 draws handed out in order, made at most
    ``chunk`` at a time on the generator's device (a few large calls for a
    model)."""

    def __init__(self, gen: torch.Generator, total: int,
                 chunk: int = 1 << 28):
        self.gen, self.left, self.chunk = gen, total, chunk
        self.buf = torch.empty((0,), device=gen.device)
        self.pos = 0

    def take(self, n: int) -> torch.Tensor:
        parts = []
        while n > 0:
            if self.pos == self.buf.numel():
                size = min(self.chunk, self.left)
                if size < n:
                    raise ValueError("the stream's draws are used up")
                self.buf = torch.randn((size,), generator=self.gen,
                                       device=self.gen.device)
                self.left -= size
                self.pos = 0
            m = min(n, self.buf.numel() - self.pos)
            parts.append(self.buf[self.pos:self.pos + m])
            self.pos += m
            n -= m
        return parts[0] if len(parts) == 1 else torch.cat(parts)
