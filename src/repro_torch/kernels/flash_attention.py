"""Wrapper of the attention CUDA kernel (``csrc/flash_attention.cu``).

``flash_attention`` replaces the Pallas TPU kernel of
``repro/kernels/flash_attention.py``: online-softmax attention with GQA, an
optional causal mask and an optional sliding window, queries at the end of
the K/V timeline, forward only.  bf16 runs on the tensor cores
(``mma.sync``, K and V staged by ``cp.async``), f32 on the CUDA cores; the
source note in ``csrc/flash_attention.cu`` gives the design and the limits.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
strides, allocates the output with ``torch.empty``, launches on the current
stream and raises if the launch fails.  q, k and v may be views whose last
axis is contiguous (the model's heads are transposed views); the output is
contiguous.  In bf16 every pointer and outer stride must be 16-byte
aligned (``cp.async`` copies 16-byte rows); the wrapper raises otherwise.
It adds one to :data:`LAUNCHES` per launch.  The plain version
is :func:`repro_torch.kernels.ref.attention`; the gradient is taken through
it by :func:`repro_torch.kernels.ops.flash_attention`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: launches of the kernel in this process (see :func:`reset_launch_counts`)
LAUNCHES = {"flash_attention": 0}

#: the head dims the kernel is compiled for
HEAD_DIMS = (64, 80, 96, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("csrc/flash_attention.cu")
        lib.fa_forward.argtypes = ([_P] * 4 + [_I] * 8 + [_L, ctypes.c_float]
                                   + [_L] * 9 + [_I, _P])
        lib.fa_forward.restype = _I
        lib.fa_kernel_attributes.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 5
        lib.fa_kernel_attributes.restype = _I
        _lib = lib
    return _lib


def kernel_attributes(dtype: torch.dtype, dh: int) -> dict[str, int]:
    """The compiled kernel for ``dtype`` and head dim ``dh``, from
    ``cudaFuncGetAttributes``: registers a thread, static and dynamic shared
    memory a CTA (bytes), local memory a thread (bytes: spills) and threads a
    CTA."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    vals = [_I() for _ in range(5)]
    err = _load().fa_kernel_attributes(int(dtype == torch.bfloat16), dh,
                                       *map(ctypes.byref, vals))
    build.raise_on(err, "fa_kernel_attributes")
    keys = ("regs", "static_smem", "dynamic_smem", "local_bytes", "threads")
    return dict(zip(keys, (x.value for x in vals)))


def misaligned(t: torch.Tensor) -> bool:
    """Whether ``t``'s data pointer or one of its three outer strides is not
    a multiple of 16 bytes (the bf16 kernel's cp.async rows need both)."""
    size = t.element_size()
    return (t.data_ptr() % 16 != 0
            or any(s * size % 16 for s in t.stride()[:3]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, Dh), k and v (B, Hkv, Skv, Dh) -> (B, Hq, Sq, Dh) in
    q's dtype.  ``window``: a key is visible to query position p only if it
    lies after p - window; ``scale`` defaults to Dh ** -0.5."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k and v must be CUDA tensors "
                         f"on one device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention: q, k and v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: expected q (B, Hq, Sq, Dh) and k, "
                         f"v (B, Hkv, Skv, Dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    if (k.shape[0] != b or k.shape[3] != dh or hkv < 1 or hq % hkv
            or min(b, sq, skv) < 1 or max(b, hq) > 65535):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} outside the kernel's limits "
                         f"(same B and Dh, Hq % Hkv == 0, B, Hq <= 65535)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if not all(t.stride(3) == 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the last axis of q, k and v must "
                         "be contiguous")
    if scale is None:
        scale = dh ** -0.5
    if q.dtype == torch.bfloat16:
        if any(map(misaligned, (q, k, v))):
            raise ValueError("flash_attention: bf16 q, k and v must be "
                             "16-byte aligned (data pointer and the three "
                             "outer strides)")
        if not (scale > 0 and hq // hkv * -(-sq // 16) <= 4 * 65535):
            raise ValueError(f"flash_attention: bf16 takes scale > 0 and "
                             f"(Hq / Hkv) * ceil(Sq / 16) <= 4 * 65535, got "
                             f"scale {scale}, q {tuple(q.shape)}")
    lib = _load()
    out = torch.empty((b, hq, sq, dh), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), int(q.dtype == torch.bfloat16), b, hq,
                         hkv, sq, skv, dh, int(causal), window or 0,
                         float(scale), *strides, q.device.index, stream)
    build.raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
