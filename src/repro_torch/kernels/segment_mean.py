"""Wrapper of the segment-sum CUDA kernels (``csrc/segment_mean.cu``).

``segment_sum`` replaces the Pallas TPU kernel of
``repro/kernels/segment_mean.py``: the (K, N) @ (N, D) barycenter reduction,
one read of W and one write of each output, bound by those bytes.  The
source note in ``csrc/segment_mean.cu`` gives the design.  :func:`route`
picks the kernel for a shape: the register kernel for N <= :data:`REG_N`
and K <= :data:`REG_K`, loading 4, 2 or 1 columns at a time by the rows'
alignment, else the column kernel; it raises outside the limit.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream and raises if the launch fails.  It adds one to
:data:`LAUNCHES` per launch.  Each shape's CTA count is asked of the
library once.  The plain version is
:func:`repro_torch.kernels.ref.segment_sum`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, reg_sweep

#: launches of the kernel in this process (see :func:`reset_launch_counts`)
LAUNCHES = {"segment_sum": 0}

#: the largest K*N the kernels take (the mix in 48 KB of shared memory)
MAX_MIX = 12288
#: the register kernel's caps: N column values and K rows of sums a thread
#: live in registers
REG_N, REG_K = 16, 4
#: the C code of each route: the column kernel, or the register kernel
#: loading 1, 2 or 4 columns at a time
ROUTES = {"cols": 0, "regs1": 1, "regs2": 2, "regs4": 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib: ctypes.CDLL | None = None
#: CTAs a launch uses, by (bf16?, route, N, D, K, device index)
_GRIDS: dict[tuple[bool, str, int, int, int, int], int] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def route(n: int, k: int, d: int, dtype: torch.dtype, data_ptr: int) -> str:
    """The kernel that W (N, D) of ``dtype`` at address ``data_ptr`` takes
    with a (K, N) mix: ``"regs<v>"`` for N <= REG_N, K <= REG_K (the
    register kernel, loading v = 4, 2 or 1 columns of a row at a time, the
    widest that D and the base's alignment allow), else ``"cols"``.  Raises ValueError outside the
    limit."""
    if not (n >= 1 and k >= 1 and d >= 1 and k * n <= MAX_MIX):
        raise ValueError(f"segment_sum: shape K={k}, N={n}, D={d} outside the "
                         f"kernel's limits (K, N, D >= 1, K*N <= {MAX_MIX})")
    if n > REG_N or k > REG_K:
        return "cols"
    return f"regs{reg_sweep.vector_width(d, (4, 2), (dtype, data_ptr))}"


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("csrc/segment_mean.cu")
        lib.sm_limits.argtypes = [ctypes.POINTER(_I)] * 3
        lib.sm_limits.restype = None
        lib.sm_grid.argtypes = [_I, _I, _I, _L, _I, _I, ctypes.POINTER(_I)]
        lib.sm_grid.restype = _I
        lib.sm_kernel_attributes.argtypes = [_I, _I, _I, ctypes.POINTER(_I),
                                             ctypes.POINTER(_I)]
        lib.sm_kernel_attributes.restype = _I
        lib.sm_segment_sum.argtypes = [_P, _I, _I, _P, _P, _I, _L, _I, _I, _I,
                                       _P]
        lib.sm_segment_sum.restype = _I
        limits = [_I() for _ in range(3)]
        lib.sm_limits(*map(ctypes.byref, limits))
        got = tuple(v.value for v in limits)
        want = (MAX_MIX, REG_N, REG_K)
        if got != want:
            raise RuntimeError(f"segment_mean.cu's limits {got} differ from "
                               f"the wrapper's {want}")
        _lib = lib
    return _lib


def kernel_attributes(dtype: torch.dtype, name: str) -> dict[str, int]:
    """The compiled kernel of (``dtype``, route ``name``), from
    ``cudaFuncGetAttributes`` on the current device: registers a thread and
    local memory a thread (bytes: spills)."""
    regs, local = _I(), _I()
    err = _load().sm_kernel_attributes(
        int(dtype == torch.bfloat16), ROUTES[name],
        torch.cuda.current_device(), ctypes.byref(regs), ctypes.byref(local))
    build.raise_on(err, "sm_kernel_attributes")
    return {"regs": regs.value, "local_bytes": local.value}


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
    name = route(n, k, d, w.dtype, w.data_ptr())
    lib = _load()
    bf16 = int(w.dtype == torch.bfloat16)
    key = (bool(bf16), name, n, d, k, w.device.index)
    grid = _GRIDS.get(key)
    if grid is None:
        out_grid = _I()
        err = lib.sm_grid(bf16, ROUTES[name], n, d, k, w.device.index,
                          ctypes.byref(out_grid))
        build.raise_on(err, "sm_grid")
        grid = _GRIDS[key] = out_grid.value
    out = torch.empty((k, d), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.sm_segment_sum(w.data_ptr(), bf16, ROUTES[name], mix.data_ptr(),
                             out.data_ptr(), n, d, k, grid, w.device.index,
                             stream)
    build.raise_on(err, "segment_sum")
    LAUNCHES["segment_sum"] += 1
    return out
