"""The port's LM stack against the reference's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; model
weights are the reference's own init, carried across with
``repro_torch.carry.transformer_from_jax``.  Bounds:
- the plain attention against ``repro.kernels.ref.attention``: 1e-5;
  against the reference's Pallas kernel (interpret mode, as
  tests/test_kernels.py runs it): rtol = atol = 2e-4 in f32, 2e-2 in bf16;
- the gradient through ``ops.flash_attention`` against ``jax.grad`` of the
  reference's ``ops.flash_attention``: 2e-3 (tests/test_kernels.py:130);
- the layers (rmsnorm, rope, mlp, ssm_apply): 1e-5;
- the reduced models of all ten assigned architectures (the VLM and
  encoder-decoder with a modal input): logits within 1e-4, the MoE aux
  within 1e-5, loss (with the aux term) within 1e-5 relative, with the
  port's flash switch on and off (on the CPU the switch routes through
  ``ops.flash_attention``, whose CPU path is the plain attention).
The configs are equal field by field, and ``lm_tokens`` bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import synthetic as jsyn
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import carry
from repro_torch.configs import registry as treg
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops, ref
from repro_torch.models import layers, ssm
from repro_torch.models import transformer as tf
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

#: (B, Hq, Hkv, Sq, Skv, Dh, causal, window, dtype): three of the
#: reference's sweep shapes, for the Pallas kernel in interpret mode
KERNEL_SHAPES = [(1, 4, 4, 100, 100, 80, True, None, "float32"),
                 (1, 4, 1, 128, 128, 64, True, 64, "float32"),
                 (2, 4, 2, 1, 300, 64, True, None, "bfloat16")]
#: and more for the plain version against the reference's
ATTN_SHAPES = KERNEL_SHAPES[:2] + [
    (2, 4, 2, 1, 300, 64, True, None, "float32"),
    (1, 2, 2, 64, 64, 128, False, None, "float32"),
    (1, 4, 2, 64, 192, 64, True, None, "float32"),
    (1, 6, 2, 48, 48, 32, False, 16, "float32")]
ARCHS = jreg.ASSIGNED


def _qkv(shape, seed=0):
    b, hq, hkv, sq, skv, dh = shape[:6]
    rng = np.random.default_rng(seed + sq * skv + hq)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh))]
    if shape[-1] == "bfloat16":
        arrays = [a.astype(ml_dtypes.bfloat16).astype(np.float32)
                  for a in arrays]
    return arrays


def _pair(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_plain_attention_matches_reference(shape):
    causal, window, dtype = shape[6:]
    jx, tx = _pair(_qkv(shape), dtype)
    got = ref.attention(*tx, causal=causal, window=window)
    want = jref.attention(*jx, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_plain_attention_matches_reference_kernel(shape):
    causal, window, dtype = shape[6:]
    jx, tx = _pair(_qkv(shape), dtype)
    got = ops.flash_attention(*tx, causal=causal, window=window)
    want = jfa.flash_attention(*jx, causal=causal, window=window,
                               block_q=64, block_k=64, interpret=True)
    assert got.dtype == tx[0].dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_flash_attention_gradient_matches_reference():
    shape = (1, 4, 2, 64, 64, 64, True, None, "float32")
    jx, tx = _pair(_qkv(shape, seed=5), "float32")
    tx = [t.requires_grad_() for t in tx]
    upstream = np.random.default_rng(9).standard_normal(
        (1, 4, 64, 64)).astype(np.float32)
    got = torch.autograd.grad(ops.flash_attention(*tx), tx,
                              torch.from_numpy(upstream))
    want = jax.grad(lambda q, k, v: jnp.sum(
        jops.flash_attention(q, k, v) * upstream), argnums=(0, 1, 2))(*jx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-3)


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)},
                         torch.from_numpy(x), 1e-6)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_matches_reference(fraction):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 11, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11) + 5, (2, 11))[:, None, :]
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                      10000.0, fraction)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, fraction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _layer_pair(make_ref, cfg_name, **replace):
    """A reduced config in both packages and the reference's init of one
    layer's parameters, as numpy."""
    jcfg = dataclasses.replace(jreg.reduced(jreg.get(cfg_name)), **replace)
    tcfg = dataclasses.replace(treg.reduced(treg.get(cfg_name)), **replace)
    params = jax.tree.map(np.asarray, make_ref(jax.random.key(3), jcfg))
    return jcfg, tcfg, params


def _port_params(params):
    return {k: carry._to_port(k, v) for k, v in params.items()}


@pytest.mark.parametrize("arch", ["starcoder2-7b", "hymba-1.5b"])
def test_mlp_matches_reference(arch):
    jcfg, tcfg, params = _layer_pair(jlayers.mlp_init, arch)
    assert jcfg.mlp == ("gelu" if arch == "starcoder2-7b" else "swiglu")
    x = np.random.default_rng(4).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)
    got = layers.mlp_apply(_port_params(params), torch.from_numpy(x))
    want = jlayers.mlp_apply(params, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ssm_apply_matches_reference():
    """S = 70 with chunk 64: two chunks, the second padded by 58 steps."""
    jcfg, tcfg, params = _layer_pair(jssm.ssm_init, "falcon-mamba-7b",
                                     d_model=64)
    rng = np.random.default_rng(6)
    params["dt_bias"] = rng.standard_normal(params["dt_bias"].shape).astype(
        np.float32)
    params["conv_b"] = rng.standard_normal(params["conv_b"].shape).astype(
        np.float32)
    x = rng.standard_normal((2, 70, 64)).astype(np.float32)
    got = ssm.ssm_apply(_port_params(params), tcfg, torch.from_numpy(x),
                        chunk=64)
    want = jssm.ssm_apply(params, jcfg, jnp.asarray(x), chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_and_loss_match_reference(arch):
    jcfg, tcfg = jreg.reduced(jreg.get(arch)), treg.reduced(treg.get(arch))
    params = jtf.init(jax.random.key(0), jcfg)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab, (2, 40)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens)}
    batch = {"tokens": torch.from_numpy(tokens)}
    if jcfg.modality:
        modal = rng.standard_normal(
            (2, jcfg.n_modal_tokens, jcfg.d_modal)).astype(np.float32)
        jbatch["modal"] = jnp.asarray(modal)
        batch["modal"] = torch.from_numpy(modal)
    want_logits, want_aux = jtf.forward(params, jcfg, jbatch)
    want_loss = float(jtf.loss_fn(params, jcfg, jbatch))
    model = carry.transformer_from_jax(jax.tree.map(np.asarray, params), tcfg)
    for flash in (False, True):
        layers.set_flash_kernel(flash)
        try:
            with torch.no_grad():
                logits, aux = tf.forward(model, batch)
                loss = float(tf.loss_fn(model, batch))
        finally:
            layers.set_flash_kernel(False)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                                   rtol=0, atol=1e-4)
        assert abs(float(aux) - float(want_aux)) <= 1e-5, (flash, aux,
                                                            want_aux)
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (flash, loss,
                                                                want_loss)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "moonshot-v1-16b-a3b",
                                  "phi-3-vision-4.2b",
                                  "seamless-m4t-large-v2"])
def test_carry_round_trips_the_reference_tree(arch):
    cfg = jreg.reduced(jreg.get(arch))
    tree = jax.tree.map(np.asarray, jtf.init(jax.random.key(1), cfg))
    back = carry.transformer_to_jax(carry.transformer_from_jax(
        tree, treg.reduced(treg.get(arch))))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(jreg.ARCHS) + sorted(jreg.EXTRA_ARCHS))
def test_configs_equal_reference(name):
    want, got = jreg.get(name), treg.get(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for cfg_w, cfg_g in ((want, got), (jreg.reduced(want), treg.reduced(got))):
        assert cfg_g.n_params() == cfg_w.n_params()
        assert cfg_g.n_active_params() == cfg_w.n_active_params()
        for prop in ("head_dim", "d_inner", "dt_rank_", "attn_free",
                     "padded_vocab"):
            assert getattr(cfg_g, prop) == getattr(cfg_w, prop), prop
    assert treg.ASSIGNED == jreg.ASSIGNED


def test_lm_tokens_bit_identical():
    for args in ((10, 129, 32001, 0), (3, 17, 512, 5)):
        np.testing.assert_array_equal(tsyn.lm_tokens(*args),
                                      jsyn.lm_tokens(*args))
