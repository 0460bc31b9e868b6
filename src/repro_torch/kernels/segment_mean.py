"""Wrapper of the segment-sum CUDA kernel (``csrc/segment_mean.cu``).

``segment_sum`` replaces the Pallas TPU kernel of
``repro/kernels/segment_mean.py``: the (K, N) @ (N, D) barycenter reduction,
one read of W and one write of each output, bound by those bytes.  The
source note in ``csrc/segment_mean.cu`` gives the design and the limits.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream and raises if the launch fails.  It adds one to
:data:`LAUNCHES` per launch.  The limit and each shape's CTA count are
asked of the library once.  The plain version is
:func:`repro_torch.kernels.ref.segment_sum`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: launches of the kernel in this process (see :func:`reset_launch_counts`)
LAUNCHES = {"segment_sum": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib: ctypes.CDLL | None = None
#: the largest K*N the kernel takes, read from the library
_MAX_MIX = 0
#: CTAs a launch uses, by (bf16?, N, D, K, device index)
_GRIDS: dict[tuple[bool, int, int, int, int], int] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _load() -> ctypes.CDLL:
    global _lib, _MAX_MIX
    if _lib is None:
        lib = build.load("csrc/segment_mean.cu")
        lib.sm_limits.argtypes = [ctypes.POINTER(_I)]
        lib.sm_limits.restype = None
        lib.sm_grid.argtypes = [_I, _I, _L, _I, _I, ctypes.POINTER(_I)]
        lib.sm_grid.restype = _I
        lib.sm_segment_sum.argtypes = [_P, _I, _P, _P, _I, _L, _I, _I, _I, _P]
        lib.sm_segment_sum.restype = _I
        max_mix = _I()
        lib.sm_limits(ctypes.byref(max_mix))
        _MAX_MIX = max_mix.value
        _lib = lib
    return _lib


def segment_sum(mix: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(K, N) f32 mix, (N, D) f32 or bf16 W -> (K, D) f32 sums ``mix @ W``."""
    if w.device.type != "cuda" or mix.device != w.device:
        raise ValueError(f"segment_sum: w and mix must be CUDA tensors on one "
                         f"device, got {w.device} and {mix.device}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segment_sum: w must be float32 or bfloat16, got "
                        f"{w.dtype}")
    if mix.dtype != torch.float32:
        raise TypeError(f"segment_sum: mix must be float32, got {mix.dtype}")
    if w.dim() != 2 or mix.dim() != 2 or mix.shape[1] != w.shape[0]:
        raise ValueError(f"segment_sum: expected mix (K, N) and w (N, D), got "
                         f"{tuple(mix.shape)} and {tuple(w.shape)}")
    if not (w.is_contiguous() and mix.is_contiguous()):
        raise ValueError("segment_sum: w and mix must be contiguous")
    k, n = mix.shape
    d = w.shape[1]
    lib = _load()
    if not (n >= 1 and k >= 1 and d >= 1 and k * n <= _MAX_MIX):
        raise ValueError(f"segment_sum: shape K={k}, N={n}, D={d} outside the "
                         f"kernel's limits (K, N, D >= 1, K*N <= {_MAX_MIX})")
    key = (w.dtype == torch.bfloat16, n, d, k, w.device.index)
    grid = _GRIDS.get(key)
    if grid is None:
        out_grid = _I()
        err = lib.sm_grid(int(key[0]), n, d, k, w.device.index,
                          ctypes.byref(out_grid))
        build.raise_on(err, "sm_grid")
        grid = _GRIDS[key] = out_grid.value
    out = torch.empty((k, d), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.sm_segment_sum(w.data_ptr(), int(key[0]), mix.data_ptr(),
                             out.data_ptr(), n, d, k, grid, w.device.index,
                             stream)
    build.raise_on(err, "segment_sum")
    LAUNCHES["segment_sum"] += 1
    return out
