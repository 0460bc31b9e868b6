"""Sketched weight geometry — cheap coalition assignment at framework scale.

Euclidean geometry survives linear dimensionality reduction: a seeded random
projection (Johnson–Lindenstrauss) or count-sketch maps each client row to an
(S,)-vector with S ≪ D such that ``‖S(ω_i) - S(ω_j)‖² ≈ ‖ω_i - ω_j‖²``, so
coalition assignment and medoid election can run on the (N, S) sketch while
barycenters and θ still stream the full (N, D) matrix once.

Both non-trivial sketchers are linear, which the sketched round exploits:
``S(Σ αᵢ ωᵢ) = Σ αᵢ S(ωᵢ)``, so sketched barycenters are a (K, N) @ (N, S)
product (:func:`repro_torch.core.fused.sketch_stage`).

Randomness.  Every column's signs are a counter-based integer hash of
(seed, global column index[, sketch row]), computed on W's device, so the
map is the same for any chunking of D and any column offset: partial
sketches of column blocks at their true offsets sum to the full sketch.  The
hash is not the reference's threefry, so the two packages' maps differ; each
sketcher also takes its map as an explicit array (``matrix`` for rproj, the
(D, S) ±1 matrix; ``signs`` for countsketch, the (D,) ±1 vector), which is
how the tests hold the port to the reference on the reference's own map.

Registry: ``identity`` (no sketch, the exact path), ``rproj`` (Rademacher
projection scaled by 1/√S, chunked over D so only a (chunk, S) block of the
map is ever densified), ``countsketch`` (global column j adds its signed
value to bucket ``j mod S``: one signed reshape-sum over W, no matmul).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core import instrument

#: columns of W a sketch step takes; bounds the densified rproj block
DEFAULT_CHUNK = 65536

_MASK31 = (1 << 31) - 1
_MUL = 0x45D9F3B        # < 2**27: a product of 31-bit values stays in int64


def _mix31(x: torch.Tensor) -> torch.Tensor:
    """Integer finaliser on int64 values in [0, 2**31), no overflow."""
    x = ((x ^ (x >> 16)) * _MUL) & _MASK31
    x = ((x ^ (x >> 16)) * _MUL) & _MASK31
    return x ^ (x >> 16)


def _column_keys(seed: int, col_offset: int, c: int,
                 device: torch.device) -> torch.Tensor:
    """(c,) per-column hash keys of global columns col_offset .. + c - 1."""
    cols = torch.arange(col_offset, col_offset + c, dtype=torch.int64,
                        device=device)
    key = _mix31(torch.tensor(seed & _MASK31, dtype=torch.int64) ^ 0x2545F491)
    h = _mix31(key.to(device) ^ (cols & _MASK31))
    return _mix31(h ^ (cols >> 31))


def rademacher_matrix(seed: int, col_offset: int, c: int, dim: int,
                      device: torch.device) -> torch.Tensor:
    """(c, dim) float32 ±1 rows of the rproj map for global columns
    ``col_offset .. col_offset + c - 1``."""
    rows = _mix31(torch.arange(dim, dtype=torch.int64, device=device)
                  ^ 0x1B873593)
    h = _mix31(_column_keys(seed, col_offset, c, device)[:, None]
               ^ rows[None, :])
    return (1 - 2 * (h & 1)).float()


def rademacher_signs(seed: int, col_offset: int, c: int,
                     device: torch.device) -> torch.Tensor:
    """(c,) float32 ±1 countsketch signs of global columns
    ``col_offset .. col_offset + c - 1``."""
    h = _mix31(_column_keys(seed, col_offset, c, device) ^ 0x68E31DA4)
    return (1 - 2 * (h & 1)).float()


@dataclasses.dataclass(frozen=True)
class Sketcher:
    """A seeded linear map R^D -> R^S applied row-wise to weight matrices.

    ``partial(w_block, col_offset)`` sketches a column block of W whose first
    column has global index ``col_offset``; full sketches are sums of
    partials.
    """

    name: str
    dim: int | None
    seed: int = 0

    @property
    def is_identity(self) -> bool:
        return self.dim is None

    def partial(self, w: torch.Tensor, col_offset: int = 0) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IdentitySketcher(Sketcher):
    """No sketch: geometry runs on full W (the exact path)."""

    name: str = "identity"
    dim: int | None = None

    def partial(self, w, col_offset=0):
        return w


@dataclasses.dataclass(frozen=True)
class RProjSketcher(Sketcher):
    """Rademacher random projection, scaled by 1/√S.

    ``matrix``: an optional injected (D, S) ±1 map; otherwise each global
    column's (S,) row comes from :func:`rademacher_matrix`, a (chunk, S)
    block at a time.  The product stays a float32 matmul (TF32 off on the
    card, as the CLI sets it).
    """

    matrix: torch.Tensor | None = dataclasses.field(
        default=None, compare=False, repr=False)

    def partial(self, w, col_offset=0):
        c = w.shape[1]
        if self.matrix is not None:
            r = self.matrix[col_offset:col_offset + c].to(w.device,
                                                          torch.float32)
        else:
            r = rademacher_matrix(self.seed, col_offset, c, self.dim,
                                  w.device)
        return (w.float() @ r) * (1.0 / math.sqrt(self.dim))


@dataclasses.dataclass(frozen=True)
class CountSketcher(Sketcher):
    """Count-sketch: global column j adds its signed value to bucket j mod S.

    ``signs``: an optional injected (D,) ±1 vector; otherwise the signs come
    from :func:`rademacher_signs`, made once per (column offset, width,
    device): the map of a fixed shape does not depend on W.  A block at
    offset o reduces into locally strided buckets and rolls them by o mod S,
    so partials at their true offsets sum to the full sketch.
    """

    signs: torch.Tensor | None = dataclasses.field(
        default=None, compare=False, repr=False)
    _made: dict = dataclasses.field(default_factory=dict, init=False,
                                    compare=False, repr=False)

    def partial(self, w, col_offset=0):
        n, c = w.shape
        if self.signs is not None:
            sg = self.signs[col_offset:col_offset + c].to(w.device,
                                                          torch.float32)
        else:
            key = (col_offset, c, str(w.device))
            if key not in self._made:
                self._made[key] = rademacher_signs(self.seed, col_offset, c,
                                                   w.device)
            sg = self._made[key]
        x = w.float() * sg[None, :]
        rem = c % self.dim
        main = c - rem
        if main:
            local = torch.sum(x[:, :main].reshape(n, -1, self.dim), dim=1)
        else:
            local = torch.zeros((n, self.dim), dtype=torch.float32,
                                device=w.device)
        if rem:
            # tail columns land in buckets 0 .. rem-1 (main % S == 0)
            local[:, :rem] += x[:, main:]
        return torch.roll(local, col_offset % self.dim, dims=1)


def sketch_block(sketcher: Sketcher, w: torch.Tensor, col_offset: int = 0,
                 chunk: int | None = None) -> torch.Tensor:
    """(N, S) sketch of a column block whose first global column is
    ``col_offset``, streamed in column chunks (the last one narrower).

    Does NOT count a W pass: callers sketching full W do
    (:func:`sketch_matrix`).
    """
    d = w.shape[1]
    c = min(d, chunk if chunk is not None else _auto_chunk(sketcher))
    out = None
    for start in range(0, d, c):
        part = sketcher.partial(w[:, start:start + c],
                                col_offset=col_offset + start)
        out = part if out is None else out + part
    return out


def sketch_matrix(sketcher: Sketcher, w: torch.Tensor,
                  chunk: int | None = None) -> torch.Tensor:
    """(N, S) sketch of the full (N, D) weight matrix: ONE full W sweep."""
    if sketcher.is_identity:
        return w
    instrument.count_w_pass()
    return sketch_block(sketcher, w, col_offset=0, chunk=chunk)


def _auto_chunk(sketcher: Sketcher) -> int:
    """Cap the densified (chunk, S) rproj block at 2**24 floats; countsketch
    densifies nothing chunk-sized and takes the whole block at once."""
    if sketcher.name == "rproj" and sketcher.dim:
        return max(1024, min(DEFAULT_CHUNK, (1 << 24) // sketcher.dim))
    if sketcher.name == "countsketch":
        return 1 << 62
    return DEFAULT_CHUNK


# -- registry -------------------------------------------------------------------

_REGISTRY: dict[str, Callable[..., Sketcher]] = {}


def register_sketcher(name: str, factory: Callable[..., Sketcher]) -> None:
    _REGISTRY[name] = factory


def available_sketchers() -> list[str]:
    return sorted(_REGISTRY)


def make_sketcher(name: str, *, dim: int | None = None,
                  seed: int = 0) -> Sketcher:
    """Build a registered sketcher; ``dim`` defaults to 256 where needed."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown sketch '{name}' "
                         f"(registered: {', '.join(available_sketchers())})")
    return _REGISTRY[name](dim=dim, seed=seed)


register_sketcher("identity", lambda dim=None, seed=0: IdentitySketcher())
register_sketcher(
    "rproj", lambda dim=None, seed=0: RProjSketcher(
        name="rproj", dim=dim or 256, seed=seed))
register_sketcher(
    "countsketch", lambda dim=None, seed=0: CountSketcher(
        name="countsketch", dim=dim or 256, seed=seed))
