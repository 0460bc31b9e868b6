"""Wrappers of the fused-round CUDA kernels (``csrc/fused_round.cu``).

``center_sq_dists`` (pass 1) and ``fused_coalition_stats`` (pass 2) replace
the Pallas TPU kernels of ``repro/kernels/fused_round.py``.  Both stream the
(N, D) client weight matrix once and are bound by its bytes; the source note
in ``csrc/fused_round.cu`` gives the design.  :func:`route` picks the kernel
for a shape: a register kernel for N <= :data:`REG_N` and K <=
:data:`REG_K` (one compiled for exactly :data:`EXACT_NK`, one for the caps),
loading 2 or 1 columns at a time by the rows' alignment, else the tile
kernel; it raises outside the limits.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates outputs and scratch with ``torch.empty``, launches on
the current stream and raises if the launch fails.  It adds one to
:data:`LAUNCHES` per launch.  Each shape's CTA count is asked of the library
once, so a call is one C call after the first.  The register kernel's
last CTA sums the partials of all CTAs; it finds itself by a ticket, a
zeroed 32-bit counter kept for each device and stream by
:mod:`repro_torch.kernels.reg_sweep`, which that CTA sets back to 0.  The
plain versions are in :mod:`repro_torch.kernels.ref`;
:mod:`repro_torch.kernels.ops` picks between the two by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, reg_sweep

#: launches of each kernel in this process (see :func:`reset_launch_counts`)
LAUNCHES = {"center_sq_dists": 0, "fused_coalition_stats": 0}

#: the largest N and N*K the kernels take (K <= N always)
MAX_N, MAX_PAIRS = 128, 2048
#: the register kernel's caps: its N*K sums and N column values a thread
#: live in registers
REG_N, REG_K = 16, 4
#: the (N, K) with a register kernel of its own, compiled for exactly that
#: shape: the paper's configuration and the CLI's default
EXACT_NK = (10, 3)
#: the C code of each route: the tile kernel, or a register tier ("exact"
#: for EXACT_NK, "regs" for the caps) loading 1 or 2 columns at a time
ROUTES = {"tile": 0, "regs1": 1, "regs2": 2, "exact1": 3, "exact2": 4}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib: ctypes.CDLL | None = None
#: (CTAs, floats of scratch) of a launch, by (pass 2?, bf16?, route, N, D, K,
#: device index)
_GRIDS: dict[tuple[bool, bool, str, int, int, int, int], tuple[int, int]] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def route(n: int, k: int, d: int, dtype: torch.dtype, data_ptr: int) -> str:
    """The kernel that W (N, D) of ``dtype`` at address ``data_ptr`` takes
    with K coalitions: ``"exact<v>"`` for (N, K) == EXACT_NK, ``"regs<v>"``
    for N <= REG_N and K <= REG_K (the register kernels, loading v = 2
    columns of a row at a time where D is even and the base 2-element
    aligned, else 1), else ``"tile"``.  Raises ValueError outside the
    limits."""
    if not (1 <= k <= n <= MAX_N and n * k <= MAX_PAIRS and d >= 1):
        raise ValueError(f"shape N={n}, K={k}, D={d} outside the fused-round "
                         f"kernels' limits (1 <= K <= N <= {MAX_N}, "
                         f"N*K <= {MAX_PAIRS}, D >= 1)")
    if n > REG_N or k > REG_K:
        return "tile"
    v = reg_sweep.vector_width(d, (2,), (dtype, data_ptr))
    return f"{'exact' if (n, k) == EXACT_NK else 'regs'}{v}"


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("csrc/fused_round.cu")
        lib.fr_limits.argtypes = [ctypes.POINTER(_I)] * 6
        lib.fr_limits.restype = None
        lib.fr_grid.argtypes = [_I, _I, _I, _I, _L, _I, _I, ctypes.POINTER(_I),
                                ctypes.POINTER(_L)]
        lib.fr_grid.restype = _I
        lib.fr_kernel_attributes.argtypes = [_I, _I, _I, _I,
                                             ctypes.POINTER(_I),
                                             ctypes.POINTER(_I)]
        lib.fr_kernel_attributes.restype = _I
        lib.fr_center_sq_dists.argtypes = [_P, _I, _I, _P, _P, _P, _P, _I, _L,
                                           _I, _I, _I, _P]
        lib.fr_center_sq_dists.restype = _I
        lib.fr_fused_coalition_stats.argtypes = [_P, _I, _I, _P, _P, _P, _P,
                                                 _P, _P, _I, _L, _I, _I, _I,
                                                 _P]
        lib.fr_fused_coalition_stats.restype = _I
        limits = [_I() for _ in range(6)]
        lib.fr_limits(*map(ctypes.byref, limits))
        got = tuple(v.value for v in limits)
        want = (MAX_N, MAX_PAIRS, REG_N, REG_K, *EXACT_NK)
        if got != want:
            raise RuntimeError(f"fused_round.cu's limits {got} differ from "
                               f"the wrapper's {want}")
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


def _launch(what: str, w: torch.Tensor, mix: torch.Tensor,
            outs: tuple[torch.Tensor, ...]) -> None:
    """Route and launch one pass on the current stream; ``outs`` are (out,)
    for pass 1 and (b, θ, med_d2) for pass 2.  Each shape's CTA count and
    scratch length are asked of the library once."""
    stats = len(outs) == 3
    n, d, k = w.shape[0], w.shape[1], mix.shape[0]
    name = route(n, k, d, w.dtype, w.data_ptr())
    lib = _load()
    bf16 = int(w.dtype == torch.bfloat16)
    dev = w.device.index
    key = (stats, bool(bf16), name, n, d, k, dev)
    if key not in _GRIDS:
        grid, scratch = _I(), _L()
        err = lib.fr_grid(int(stats), bf16, ROUTES[name], n, d, k, dev,
                          ctypes.byref(grid), ctypes.byref(scratch))
        build.raise_on(err, "fr_grid")
        _GRIDS[key] = grid.value, scratch.value
    grid, scratch = _GRIDS[key]
    stream = torch.cuda.current_stream(w.device).cuda_stream
    ticket = reg_sweep.ticket(w.device, stream)
    partials = torch.empty((scratch,), dtype=torch.float32, device=w.device)
    *stats_out, out = (t.data_ptr() for t in outs)
    fn = lib.fr_fused_coalition_stats if stats else lib.fr_center_sq_dists
    err = fn(w.data_ptr(), bf16, ROUTES[name], mix.data_ptr(), *stats_out,
             partials.data_ptr(), ticket.data_ptr(), out, n, d, k, grid, dev,
             stream)
    build.raise_on(err, what)
    LAUNCHES[what] += 1


def kernel_attributes(stats: bool, dtype: torch.dtype,
                      name: str) -> dict[str, int]:
    """The compiled kernel of (pass 2?, ``dtype``, route ``name``), from
    ``cudaFuncGetAttributes`` on the current device: registers a thread and
    local memory a thread (bytes: spills)."""
    regs, local = _I(), _I()
    err = _load().fr_kernel_attributes(
        int(stats), int(dtype == torch.bfloat16), ROUTES[name],
        torch.cuda.current_device(), ctypes.byref(regs), ctypes.byref(local))
    build.raise_on(err, "fr_kernel_attributes")
    return {"regs": regs.value, "local_bytes": local.value}


def center_sq_dists(w: torch.Tensor, conehot: torch.Tensor) -> torch.Tensor:
    """Pass 1 on the card: (N, D) W, (K, N) center one-hot -> (N, K) f32."""
    n, _, k = _check(w, conehot, "center_sq_dists")
    out = torch.empty((n, k), dtype=torch.float32, device=w.device)
    _launch("center_sq_dists", w, conehot, (out,))
    return out


def fused_coalition_stats(w: torch.Tensor, m: torch.Tensor,
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 2 on the card: one read of W -> b (K, D), θ (D,), med_d2 (N, K)."""
    n, d, k = _check(w, m, "fused_coalition_stats")
    b = torch.empty((k, d), dtype=torch.float32, device=w.device)
    theta = torch.empty((d,), dtype=torch.float32, device=w.device)
    med_d2 = torch.empty((n, k), dtype=torch.float32, device=w.device)
    _launch("fused_coalition_stats", w, m, (b, theta, med_d2))
    return b, theta, med_d2
