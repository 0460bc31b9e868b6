"""Wrappers of the distance CUDA kernels (``csrc/pairwise_dist.cu``).

``sq_dists_to_points`` and ``pairwise_sq_dists`` replace the Pallas TPU
kernels of ``repro/kernels/pairwise_dist.py``.  Both stream the (N, D)
matrix once and are bound by its bytes (by their launch at the sketch
widths); the source note in ``csrc/pairwise_dist.cu`` gives the design.
:func:`route` picks ``sq_dists_to_points``'s kernel for a shape: the warp
kernel at the sketch widths (D <= :data:`SMALL_D`), a register kernel at
full width for N <= :data:`REG_N` and K <= :data:`REG_K` (one compiled for
exactly :data:`EXACT_NK`, one for the caps), loading 2 or 1 columns at a
time by the rows' alignment, else the tile kernel; it raises outside the
limits.  :func:`pairwise_route` picks ``pairwise_sq_dists``'s kernel: the
pairwise register kernel at full width (D > :data:`SMALL_D`) for
N <= :data:`PAIR_REG_N`, loading 4, 2 or 1 columns at a time by the rows'
alignment, else the tile kernel; it raises outside the limits.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates outputs and scratch with ``torch.empty``, launches on
the current stream and raises if the launch fails.  It adds one to
:data:`LAUNCHES` per call that launches.  Each shape's CTA count is asked
of the library once.  The register kernels' last CTA finds itself by the
ticket of :mod:`repro_torch.kernels.reg_sweep`.  The plain versions are in
:mod:`repro_torch.kernels.ref`; :mod:`repro_torch.kernels.ops` picks between
the two by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, reg_sweep

#: launches of each kernel in this process (see :func:`reset_launch_counts`)
LAUNCHES = {"sq_dists_to_points": 0, "pairwise_sq_dists": 0}

#: sq_dists_to_points takes N <= MAX_N, K <= MAX_K, N*K <= MAX_PAIRS;
#: pairwise_sq_dists takes N <= MAX_PAIRWISE_N
MAX_N, MAX_K, MAX_PAIRS, MAX_PAIRWISE_N = 128, 64, 2048, 64
#: the sketch widths: sq_dists_to_points takes the warp kernel up to here
SMALL_D = 2048
#: the register kernel's caps: its N*K sums and N + K column values a
#: thread live in registers
REG_N, REG_K = 16, 4
#: the pairwise register kernel's cap: its N(N-1)/2 sums and N column
#: values a thread live in registers
PAIR_REG_N = 13
#: the (N, K) with a register kernel of its own, compiled for exactly that
#: shape: the composed round's at the CLI's defaults
EXACT_NK = (10, 3)
#: the C code of each sq_dists_to_points route: the tile kernel, a register
#: tier ("exact" for EXACT_NK, "regs" for the caps) loading 1 or 2 columns
#: at a time, or the warp kernel of the sketch widths
ROUTES = {"tile": 0, "regs1": 1, "regs2": 2, "exact1": 3, "exact2": 4,
          "warp": 5}
#: the C code of each pairwise_sq_dists route: the tile kernel, or the
#: pairwise register kernel loading 1, 2 or 4 columns at a time
PAIRWISE_ROUTES = {"tile": 0, "pregs1": 6, "pregs2": 7, "pregs4": 8}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DTYPES = (torch.float32, torch.bfloat16)
_lib: ctypes.CDLL | None = None
#: (CTAs, floats of scratch) of a launch, by (pairwise?, W bf16?, P bf16?,
#: route, N, D, K, device)
_GRIDS: dict[tuple[bool, bool, bool, str, int, int, int, int],
             tuple[int, int]] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def route(n: int, k: int, d: int, w_dtype: torch.dtype, w_ptr: int,
          p_dtype: torch.dtype, p_ptr: int) -> str:
    """The kernel that ``sq_dists_to_points`` takes for W (N, D) of
    ``w_dtype`` at ``w_ptr`` and P (K, D) of ``p_dtype`` at ``p_ptr``:
    ``"warp"`` for D <= SMALL_D; ``"exact<v>"`` for (N, K) == EXACT_NK and
    ``"regs<v>"`` for N <= REG_N, K <= REG_K (the register kernels, loading
    v = 2 columns of a row at a time where D is even and both bases are
    2-element aligned, else 1); else ``"tile"``.  Raises ValueError outside
    the limits."""
    if not (1 <= n <= MAX_N and 1 <= k <= MAX_K and n * k <= MAX_PAIRS
            and d >= 1):
        raise ValueError(f"sq_dists_to_points: shape N={n}, K={k}, D={d} "
                         f"outside the kernel's limits (1 <= N <= {MAX_N}, "
                         f"1 <= K <= {MAX_K}, N*K <= {MAX_PAIRS}, D >= 1)")
    if d <= SMALL_D:
        return "warp"
    if n > REG_N or k > REG_K:
        return "tile"
    v = reg_sweep.vector_width(d, (2,), (w_dtype, w_ptr), (p_dtype, p_ptr))
    return f"{'exact' if (n, k) == EXACT_NK else 'regs'}{v}"


def pairwise_route(n: int, d: int, dtype: torch.dtype, data_ptr: int) -> str:
    """The kernel that ``pairwise_sq_dists`` takes for W (N, D) of ``dtype``
    at ``data_ptr``: ``"pregs<v>"`` for D > SMALL_D and N <= PAIR_REG_N (the
    pairwise register kernel, loading v = 4, 2 or 1 columns of a row at a
    time, the widest that D and the base's alignment allow), else
    ``"tile"``.  Raises ValueError outside the limits."""
    if not (1 <= n <= MAX_PAIRWISE_N and d >= 1):
        raise ValueError(f"pairwise_sq_dists: shape N={n}, D={d} outside the "
                         f"kernel's limits (1 <= N <= {MAX_PAIRWISE_N}, "
                         f"D >= 1)")
    if d <= SMALL_D or n > PAIR_REG_N:
        return "tile"
    return f"pregs{reg_sweep.vector_width(d, (4, 2), (dtype, data_ptr))}"


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("csrc/pairwise_dist.cu")
        lib.pd_limits.argtypes = [ctypes.POINTER(_I)] * 10
        lib.pd_limits.restype = None
        lib.pd_grid.argtypes = [_I, _I, _I, _I, _I, _L, _I, _I,
                                ctypes.POINTER(_I), ctypes.POINTER(_L)]
        lib.pd_grid.restype = _I
        lib.pd_kernel_attributes.argtypes = [_I, _I, _I, _I, _I,
                                             ctypes.POINTER(_I),
                                             ctypes.POINTER(_I)]
        lib.pd_kernel_attributes.restype = _I
        lib.pd_sq_dists_to_points.argtypes = [_P, _I, _P, _I, _I, _P, _P, _P,
                                              _I, _L, _I, _I, _I, _P]
        lib.pd_sq_dists_to_points.restype = _I
        lib.pd_pairwise_sq_dists.argtypes = [_P, _I, _I, _P, _P, _P, _I, _L,
                                             _I, _I, _P]
        lib.pd_pairwise_sq_dists.restype = _I
        limits = [_I() for _ in range(10)]
        lib.pd_limits(*map(ctypes.byref, limits))
        got = tuple(v.value for v in limits)
        want = (MAX_N, MAX_K, MAX_PAIRS, MAX_PAIRWISE_N, SMALL_D, REG_N,
                REG_K, *EXACT_NK, PAIR_REG_N)
        if got != want:
            raise RuntimeError(f"pairwise_dist.cu's limits {got} differ from "
                               f"the wrapper's {want}")
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
          name: str, n: int, d: int, k: int) -> tuple[int, int]:
    """The launch's CTA count and floats of scratch, asked of the library
    once per shape and route."""
    p_bf16 = p is not None and p.dtype == torch.bfloat16
    key = (pairwise, w.dtype == torch.bfloat16, p_bf16, name, n, d, k,
           w.device.index)
    got = _GRIDS.get(key)
    if got is None:
        grid, scratch = _I(), _L()
        code = (PAIRWISE_ROUTES if pairwise else ROUTES)[name]
        err = lib.pd_grid(int(pairwise), int(key[1]), int(p_bf16), code, n,
                          d, k, w.device.index,
                          ctypes.byref(grid), ctypes.byref(scratch))
        build.raise_on(err, "pd_grid")
        got = _GRIDS[key] = grid.value, scratch.value
    return got


def _attributes(pairwise: bool, w_dtype: torch.dtype, p_dtype: torch.dtype,
                code: int) -> dict[str, int]:
    regs, local = _I(), _I()
    err = _load().pd_kernel_attributes(
        int(pairwise), int(w_dtype == torch.bfloat16),
        int(p_dtype == torch.bfloat16), code, torch.cuda.current_device(),
        ctypes.byref(regs), ctypes.byref(local))
    build.raise_on(err, "pd_kernel_attributes")
    return {"regs": regs.value, "local_bytes": local.value}


def kernel_attributes(w_dtype: torch.dtype, p_dtype: torch.dtype,
                      name: str) -> dict[str, int]:
    """The compiled ``sq_dists_to_points`` kernel of (W dtype, P dtype,
    route ``name``), from ``cudaFuncGetAttributes`` on the current device:
    registers a thread and local memory a thread (bytes: spills)."""
    return _attributes(False, w_dtype, p_dtype, ROUTES[name])


def pairwise_kernel_attributes(dtype: torch.dtype, name: str
                               ) -> dict[str, int]:
    """The compiled ``pairwise_sq_dists`` kernel of (W dtype, route
    ``name``), as :func:`kernel_attributes` gives it."""
    return _attributes(True, dtype, dtype, PAIRWISE_ROUTES[name])


def sq_dists_to_points(w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(N, D) W, (K, D) points, each f32 or bf16 -> (N, K) f32 squared
    distances, clamped at 0."""
    _check("sq_dists_to_points", w, p)
    n, d = w.shape
    k = p.shape[0]
    if p.shape[1] != d:
        raise ValueError(f"sq_dists_to_points: expected w (N, D) and p (K, D), "
                         f"got {tuple(w.shape)} and {tuple(p.shape)}")
    name = route(n, k, d, w.dtype, w.data_ptr(), p.dtype, p.data_ptr())
    lib = _load()
    grid, scratch = _grid(lib, False, w, p, name, n, d, k)
    partials = torch.empty((scratch,), dtype=torch.float32, device=w.device)
    out = torch.empty((n, k), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.pd_sq_dists_to_points(
        w.data_ptr(), int(w.dtype == torch.bfloat16), p.data_ptr(),
        int(p.dtype == torch.bfloat16), ROUTES[name], partials.data_ptr(),
        reg_sweep.ticket(w.device, stream).data_ptr(), out.data_ptr(), n, d,
        k, grid, w.device.index, stream)
    build.raise_on(err, "sq_dists_to_points")
    LAUNCHES["sq_dists_to_points"] += 1
    return out


def pairwise_sq_dists(w: torch.Tensor) -> torch.Tensor:
    """(N, D) W, f32 or bf16 -> (N, N) f32 squared distances, clamped at 0,
    symmetric, with the diagonal exactly 0."""
    _check("pairwise_sq_dists", w)
    n, d = w.shape
    name = pairwise_route(n, d, w.dtype, w.data_ptr())
    lib = _load()
    grid, scratch = _grid(lib, True, w, None, name, n, d, 0)
    partials = torch.empty((scratch,), dtype=torch.float32, device=w.device)
    out = torch.empty((n, n), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.pd_pairwise_sq_dists(
        w.data_ptr(), int(w.dtype == torch.bfloat16), PAIRWISE_ROUTES[name],
        partials.data_ptr(), reg_sweep.ticket(w.device, stream).data_ptr(),
        out.data_ptr(), n, d, grid, w.device.index, stream)
    build.raise_on(err, "pairwise_sq_dists")
    LAUNCHES["pairwise_sq_dists"] += 1
    return out
