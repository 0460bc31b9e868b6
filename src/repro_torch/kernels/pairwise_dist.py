"""Wrappers of the distance CUDA kernels (``csrc/pairwise_dist.cu``).

``sq_dists_to_points`` and ``pairwise_sq_dists`` replace the Pallas TPU
kernels of ``repro/kernels/pairwise_dist.py``.  Both stream the (N, D)
matrix once and are bound by its bytes (by their launch at the sketch
widths); the source note in ``csrc/pairwise_dist.cu`` gives the design and
the shape limits.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates outputs and scratch with ``torch.empty``, launches on
the current stream and raises if the launch fails.  It adds one to
:data:`LAUNCHES` per call that launches.  The shape limits and each shape's
CTA count are asked of the library once.  The plain versions are in
:mod:`repro_torch.kernels.ref`; :mod:`repro_torch.kernels.ops` picks between
the two by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: launches of each kernel in this process (see :func:`reset_launch_counts`)
LAUNCHES = {"sq_dists_to_points": 0, "pairwise_sq_dists": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DTYPES = (torch.float32, torch.bfloat16)
_lib: ctypes.CDLL | None = None
#: (largest N, largest K, largest N*K, largest pairwise N), from the library
_LIMITS: tuple[int, int, int, int] = (0, 0, 0, 0)
#: CTAs a launch uses, by (pairwise?, W bf16?, P bf16?, N, D, K, device)
_GRIDS: dict[tuple[bool, bool, bool, int, int, int, int], int] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _load() -> ctypes.CDLL:
    global _lib, _LIMITS
    if _lib is None:
        lib = build.load("csrc/pairwise_dist.cu")
        lib.pd_limits.argtypes = [ctypes.POINTER(_I)] * 4
        lib.pd_limits.restype = None
        lib.pd_grid.argtypes = [_I, _I, _I, _I, _L, _I, _I, ctypes.POINTER(_I)]
        lib.pd_grid.restype = _I
        lib.pd_sq_dists_to_points.argtypes = [_P, _I, _P, _I, _P, _P, _I, _L,
                                              _I, _I, _I, _P]
        lib.pd_sq_dists_to_points.restype = _I
        lib.pd_pairwise_sq_dists.argtypes = [_P, _I, _P, _P, _I, _L, _I, _I,
                                             _P]
        lib.pd_pairwise_sq_dists.restype = _I
        limits = [_I() for _ in range(4)]
        lib.pd_limits(*map(ctypes.byref, limits))
        _LIMITS = tuple(v.value for v in limits)
        _lib = lib
    return _lib


def _check(what: str, *ts: torch.Tensor) -> None:
    w = ts[0]
    if w.device.type != "cuda" or any(t.device != w.device for t in ts):
        raise ValueError(f"{what}: inputs must be CUDA tensors on one device, "
                         f"got {[str(t.device) for t in ts]}")
    for t in ts:
        if t.dtype not in _DTYPES:
            raise TypeError(f"{what}: inputs must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{what}: inputs must be 2-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def _grid(lib, pairwise: bool, w: torch.Tensor, p: torch.Tensor | None,
          n: int, d: int, k: int) -> int:
    """The launch's CTA count, asked of the library once per shape."""
    p_bf16 = p is not None and p.dtype == torch.bfloat16
    key = (pairwise, w.dtype == torch.bfloat16, p_bf16, n, d, k,
           w.device.index)
    grid = _GRIDS.get(key)
    if grid is None:
        out = _I()
        err = lib.pd_grid(int(pairwise), int(key[1]), int(p_bf16), n, d, k,
                          w.device.index, ctypes.byref(out))
        build.raise_on(err, "pd_grid")
        grid = _GRIDS[key] = out.value
    return grid


def _scratch(npairs: int, grid: int, w: torch.Tensor) -> torch.Tensor:
    """The (npairs, grid) partials; none when one CTA writes the output."""
    shape = (npairs, grid) if grid > 1 else (0,)
    return torch.empty(shape, dtype=torch.float32, device=w.device)


def sq_dists_to_points(w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(N, D) W, (K, D) points, each f32 or bf16 -> (N, K) f32 squared
    distances, clamped at 0."""
    _check("sq_dists_to_points", w, p)
    n, d = w.shape
    k = p.shape[0]
    if p.shape[1] != d:
        raise ValueError(f"sq_dists_to_points: expected w (N, D) and p (K, D), "
                         f"got {tuple(w.shape)} and {tuple(p.shape)}")
    lib = _load()
    max_n, max_k, max_pairs, _ = _LIMITS
    if not (1 <= n <= max_n and 1 <= k <= max_k and n * k <= max_pairs
            and d >= 1):
        raise ValueError(f"sq_dists_to_points: shape N={n}, K={k}, D={d} "
                         f"outside the kernel's limits (1 <= N <= {max_n}, "
                         f"1 <= K <= {max_k}, N*K <= {max_pairs}, D >= 1)")
    grid = _grid(lib, False, w, p, n, d, k)
    partials = _scratch(n * k, grid, w)
    out = torch.empty((n, k), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.pd_sq_dists_to_points(
        w.data_ptr(), int(w.dtype == torch.bfloat16), p.data_ptr(),
        int(p.dtype == torch.bfloat16), partials.data_ptr(), out.data_ptr(),
        n, d, k, grid, w.device.index, stream)
    build.raise_on(err, "sq_dists_to_points")
    LAUNCHES["sq_dists_to_points"] += 1
    return out


def pairwise_sq_dists(w: torch.Tensor) -> torch.Tensor:
    """(N, D) W, f32 or bf16 -> (N, N) f32 squared distances, clamped at 0,
    symmetric, with the diagonal exactly 0."""
    _check("pairwise_sq_dists", w)
    n, d = w.shape
    lib = _load()
    max_n = _LIMITS[3]
    if not (1 <= n <= max_n and d >= 1):
        raise ValueError(f"pairwise_sq_dists: shape N={n}, D={d} outside the "
                         f"kernel's limits (1 <= N <= {max_n}, D >= 1)")
    grid = _grid(lib, True, w, None, n, d, 0)
    partials = _scratch(n * (n - 1) // 2, grid, w)
    out = torch.empty((n, n), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.pd_pairwise_sq_dists(
        w.data_ptr(), int(w.dtype == torch.bfloat16), partials.data_ptr(),
        out.data_ptr(), n, d, grid, w.device.index, stream)
    build.raise_on(err, "pairwise_sq_dists")
    LAUNCHES["pairwise_sq_dists"] += 1
    return out
