"""The bf16 attention kernel's numerics, emulated on the CPU.

``csrc/flash_attention.cu`` runs bf16 attention on the tensor cores: q, k and
v stay bf16, S = Q K^T sums exact bf16 products in f32, the online softmax
works in f32 on 64-key tiles (m and l with the -1e30 sentinel, l summing the
f32 P), and P is rounded to bf16 before O += P V, which sums in f32.  The
TPU kernel multiplies P in f32 instead.  ``_emulate`` repeats the kernel's
steps tile by tile in plain torch; the tests hold it to the reference's
``repro.kernels.ref.attention`` with the reference's bf16 tolerance
(rtol = atol = 2e-2, tests/test_kernels.py), at the reference's sweep
(``chip_smoke.FLASH_SWEEP``) and at a narrow shape like the pretrain path's
(S = 129, GQA 5:1, window 1024).  So the design's rounding meets the
reference's bound before any card runs it.  Inputs are made with numpy from
a seed and rounded to bf16 once, for both sides.
"""
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

TOL = 2e-2
NEG_INF = -1e30
TILE = 64
#: narrow shapes like the pretrain path's: (B, Hq, Hkv, Sq, Skv, Dh, causal,
#: window); the second has ragged q-tiles against a longer timeline
PATH_LIKE = [(2, 5, 1, 129, 129, 64, True, 1024),
             (1, 5, 1, 17, 300, 64, True, 100)]


def _emulate(q, k, v, *, causal, window, scale=None):
    """The tensor-core kernel's arithmetic in plain torch: bf16 q, k, v ->
    bf16 (B, Hq, Sq, Dh)."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale_log2 = (dh ** -0.5 if scale is None else scale) * math.log2(math.e)
    kq = torch.repeat_interleave(k, hq // hkv, dim=1).float()
    vq = torch.repeat_interleave(v, hq // hkv, dim=1).float()
    qf = q.float()
    pos = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((b, hq, sq, 1), NEG_INF)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, dh))
    for k0 in range(0, skv, TILE):
        kt, vt = kq[:, :, k0:k0 + TILE], vq[:, :, k0:k0 + TILE]
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones((sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            ok &= kpos <= pos
        if window is not None:
            ok &= kpos > pos - window
        s = torch.where(ok, qf @ kt.transpose(-1, -2) * scale_log2,
                        torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(s <= NEG_INF, torch.tensor(0.0),
                        torch.exp2(s - m_new))
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vt
        m = m_new
    return (acc / torch.where(l == 0, torch.tensor(1.0), l)).to(torch.bfloat16)


def _inputs(shape, seed=0):
    """q, k, v as bf16 numpy values (ml_dtypes) for a (B, Hq, Hkv, Sq, Skv,
    Dh, ...) shape."""
    b, hq, hkv, sq, skv, dh = shape[:6]
    rng = np.random.default_rng(seed + sq * skv + hq)
    return [rng.standard_normal(s).astype(np.float32).astype(ml_dtypes.bfloat16)
            for s in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh))]


def _torch(a):
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("shape", list(chip_smoke.FLASH_SWEEP) + PATH_LIKE)
def test_tensor_core_numerics_meet_the_reference_bound(shape):
    causal, window = shape[6:]
    q, k, v = _inputs(shape)
    got = _emulate(*map(_torch, (q, k, v)), causal=causal, window=window)
    want = jref.attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                          window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shape", PATH_LIKE)
def test_rounding_p_costs_less_than_the_output_rounding(shape):
    """Against the f32 attention on the same bf16 values, rounding P to bf16
    adds an error of the order of the output's own bf16 rounding (2^-9
    relative), far inside 2e-2."""
    causal, window = shape[6:]
    q, k, v = map(_torch, _inputs(shape))
    exact = tref.attention(q.float(), k.float(), v.float(), causal=causal,
                           window=window)
    got = _emulate(q, k, v, causal=causal, window=window).float()
    rounded_out = exact.to(torch.bfloat16).float()
    scale = float(exact.abs().max())
    assert float((got - exact).abs().max()) <= 4 * 2 ** -9 * scale
    assert float((rounded_out - exact).abs().max()) <= 2 ** -8 * scale


def test_misaligned_flags_what_the_bf16_kernel_cannot_copy():
    """The wrapper refuses a bf16 view whose data pointer or outer strides
    are not 16-byte multiples; the model's transposed views pass."""
    t = torch.zeros((2, 4, 33, 64), dtype=torch.bfloat16)
    assert not tfa.misaligned(t)
    assert not tfa.misaligned(t.transpose(1, 2).contiguous().transpose(1, 2))
    flat = torch.zeros(t.numel() + 1, dtype=torch.bfloat16)
    assert tfa.misaligned(flat[1:].view(t.shape))
    padded = torch.zeros((2, 4, 33, 68), dtype=torch.bfloat16)
    assert tfa.misaligned(padded[..., :64])
    assert not tfa.misaligned(padded.float()[..., :64])
