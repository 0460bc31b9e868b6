"""Wrappers of the fused-round CUDA kernels (``csrc/fused_round.cu``).

``center_sq_dists`` (pass 1) and ``fused_coalition_stats`` (pass 2) replace
the Pallas TPU kernels of ``repro/kernels/fused_round.py``.  Both stream the
(N, D) client weight matrix once and are bound by its bytes; the source note
in ``csrc/fused_round.cu`` gives the design and the shape limits.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates outputs and scratch with ``torch.empty``, launches on
the current stream and raises if the launch fails.  It adds one to
:data:`LAUNCHES` per launch.  The shape limits and each shape's CTA count
are asked of the library once, so a call is one C call after the first.  The plain versions are in
:mod:`repro_torch.kernels.ref`; :mod:`repro_torch.kernels.ops` picks between
the two by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: launches of each kernel in this process (see :func:`reset_launch_counts`)
LAUNCHES = {"center_sq_dists": 0, "fused_coalition_stats": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib: ctypes.CDLL | None = None
#: (largest N, largest N*K) the kernels take, read from the library
_LIMITS: tuple[int, int] = (0, 0)
#: CTAs a launch uses, by (pass 2?, bf16?, N, D, K, device index)
_GRIDS: dict[tuple[bool, bool, int, int, int, int], int] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _load() -> ctypes.CDLL:
    global _lib, _LIMITS
    if _lib is None:
        lib = build.load("csrc/fused_round.cu")
        lib.fr_limits.argtypes = [ctypes.POINTER(_I), ctypes.POINTER(_I)]
        lib.fr_limits.restype = None
        lib.fr_grid.argtypes = [_I, _I, _I, _L, _I, _I, ctypes.POINTER(_I)]
        lib.fr_grid.restype = _I
        lib.fr_center_sq_dists.argtypes = [_P, _I, _P, _P, _P, _I, _L, _I, _I,
                                           _I, _P]
        lib.fr_center_sq_dists.restype = _I
        lib.fr_fused_coalition_stats.argtypes = [_P, _I, _P, _P, _P, _P, _P,
                                                 _I, _L, _I, _I, _I, _P]
        lib.fr_fused_coalition_stats.restype = _I
        max_n, max_pairs = _I(), _I()
        lib.fr_limits(ctypes.byref(max_n), ctypes.byref(max_pairs))
        _LIMITS = (max_n.value, max_pairs.value)
        _lib = lib
    return _lib


def _check(w: torch.Tensor, mix: torch.Tensor, what: str) -> tuple[int, int, int]:
    if w.device.type != "cuda" or mix.device != w.device:
        raise ValueError(f"{what}: w and the (K, N) matrix must be CUDA "
                         f"tensors on one device, got {w.device} and "
                         f"{mix.device}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: w must be float32 or bfloat16, got {w.dtype}")
    if mix.dtype != torch.float32:
        raise TypeError(f"{what}: the (K, N) matrix must be float32, got "
                        f"{mix.dtype}")
    if w.dim() != 2 or mix.dim() != 2 or mix.shape[1] != w.shape[0]:
        raise ValueError(f"{what}: expected w (N, D) and (K, N), got "
                         f"{tuple(w.shape)} and {tuple(mix.shape)}")
    if not (w.is_contiguous() and mix.is_contiguous()):
        raise ValueError(f"{what}: w and the (K, N) matrix must be contiguous")
    return w.shape[0], w.shape[1], mix.shape[0]


def _check_limits(n: int, d: int, k: int, what: str) -> None:
    max_n, max_pairs = _LIMITS
    if not (1 <= n <= max_n and 1 <= k <= n and n * k <= max_pairs and d >= 1):
        raise ValueError(f"{what}: shape N={n}, K={k}, D={d} outside the "
                         f"kernel's limits (1 <= K <= N <= {max_n}, "
                         f"N*K <= {max_pairs}, D >= 1)")


def _grid(lib, stats: bool, w: torch.Tensor, n: int, d: int, k: int) -> int:
    """The launch's CTA count, asked of the library once per shape."""
    key = (stats, w.dtype == torch.bfloat16, n, d, k, w.device.index)
    grid = _GRIDS.get(key)
    if grid is None:
        out = _I()
        err = lib.fr_grid(int(stats), int(key[1]), n, d, k, w.device.index,
                          ctypes.byref(out))
        build.raise_on(err, "fr_grid")
        grid = _GRIDS[key] = out.value
    return grid


def center_sq_dists(w: torch.Tensor, conehot: torch.Tensor) -> torch.Tensor:
    """Pass 1 on the card: (N, D) W, (K, N) center one-hot -> (N, K) f32."""
    n, d, k = _check(w, conehot, "center_sq_dists")
    lib = _load()
    _check_limits(n, d, k, "center_sq_dists")
    grid = _grid(lib, False, w, n, d, k)
    partials = torch.empty((n * k, grid), dtype=torch.float32, device=w.device)
    out = torch.empty((n, k), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.fr_center_sq_dists(
        w.data_ptr(), int(w.dtype == torch.bfloat16), conehot.data_ptr(),
        partials.data_ptr(), out.data_ptr(), n, d, k, grid, w.device.index,
        stream)
    build.raise_on(err, "center_sq_dists")
    LAUNCHES["center_sq_dists"] += 1
    return out


def fused_coalition_stats(w: torch.Tensor, m: torch.Tensor,
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 2 on the card: one read of W -> b (K, D), θ (D,), med_d2 (N, K)."""
    n, d, k = _check(w, m, "fused_coalition_stats")
    lib = _load()
    _check_limits(n, d, k, "fused_coalition_stats")
    grid = _grid(lib, True, w, n, d, k)
    partials = torch.empty((n * k, grid), dtype=torch.float32, device=w.device)
    b = torch.empty((k, d), dtype=torch.float32, device=w.device)
    theta = torch.empty((d,), dtype=torch.float32, device=w.device)
    med_d2 = torch.empty((n, k), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.fr_fused_coalition_stats(
        w.data_ptr(), int(w.dtype == torch.bfloat16), m.data_ptr(),
        b.data_ptr(), theta.data_ptr(), partials.data_ptr(), med_d2.data_ptr(),
        n, d, k, grid, w.device.index, stream)
    build.raise_on(err, "fused_coalition_stats")
    LAUNCHES["fused_coalition_stats"] += 1
    return b, theta, med_d2
