"""The port's decode cache, ``prefill`` and ``decode_step`` against the
reference's, on the CPU, for the reduced (f32) configs of all ten assigned
architectures.

Inputs are numpy from a seed, fed to both packages; weights are the
reference's init carried across (``carry.transformer_from_jax``), and the
caches are compared through ``carry.cache_to_jax``.  Bounds:
- ``init_cache``: the reference's keys, shapes and dtypes, with
  ``ring=True`` and without;
- prefill logits within atol 1e-4 (as the full forward,
  tests/test_torch_transformer.py); the filled cache (``k``, ``v``,
  ``conv``, ``h``, ``memory``) within rtol = atol = 1e-5, the bound of the
  layer tests (the SSM state ``h`` reaches |h| ~ 6, where an absolute 1e-5
  is 20 f32 ulps after 12 steps of the recurrence), and ``index`` equal;
- four decode steps under teacher forcing (both sides fed the reference's
  argmax tokens, so no argmax tie can fork the runs): each step's logits
  within atol 1e-4, the cache after the last within rtol = atol = 1e-5;
- the port's own decode against its full forward (tests/test_archs.py:72):
  rtol = atol = 2e-3, with MoE capacity 8.0 so that no routing drop can
  differ between T = B·S and T = B;
- the ring buffer against the full cache past the window (window 8, 24
  tokens; tests/test_ring_cache.py:31), and against the reference's ring:
  logits atol 1e-4; its slots within rtol = atol = 1e-5, and the SSM state
  after the 24 steps within 1e-5 of its max |h| (an entry that cancels to
  ~0.03 carries the rounding of entries ~100x larger);
- ``ssm_step`` and the stateful ``ssm_apply``: rtol = atol = 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import carry
from repro_torch.configs import registry as treg
from repro_torch.launch import steps
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

B, S, STEPS = 2, 12, 4
LOGIT_ATOL = 1e-4
CACHE_TOL = 1e-5


def _prefix(cfg):
    return cfg.n_modal_tokens if (cfg.modality and not cfg.enc_dec) else 0


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens)}
    if cfg.modality:
        modal = rng.standard_normal(
            (B, cfg.n_modal_tokens, cfg.d_modal)).astype(np.float32)
        jb["modal"], tb["modal"] = jnp.asarray(modal), torch.from_numpy(modal)
    return jb, tb


@pytest.fixture(scope="module")
def runs():
    """Per arch, once: both models on the reference's weights, and the
    reference's prefill and teacher-forced decode with the port's beside."""
    memo = {}

    def run(arch):
        if arch in memo:
            return memo[arch]
        jcfg = jreg.reduced(jreg.get(arch))
        tcfg = treg.reduced(treg.get(arch))
        params = jax.tree.map(np.asarray, jtf.init(jax.random.key(0), jcfg))
        model = carry.transformer_from_jax(params, tcfg)
        jb, tb = _batches(jcfg, seed=11)
        max_len = _prefix(jcfg) + S + STEPS
        jprefill = jax.jit(lambda p, b, c: jtf.prefill(p, jcfg, b, c))
        jdecode = jax.jit(lambda p, t, c: jtf.decode_step(p, jcfg, t, c))
        jc = jtf.init_cache(jcfg, B, max_len)
        jlog, jc = jprefill(params, jb, jc)
        with torch.no_grad():
            tlog, tc = tf.prefill(model, tb, tf.init_cache(tcfg, B, max_len))
        out = {"jcfg": jcfg, "tcfg": tcfg, "params": params, "model": model,
               "prefill": (np.asarray(jlog), tlog.numpy(),
                           jax.tree.map(np.asarray, jc),
                           carry.cache_to_jax(tc)),
               "decode": []}
        for _ in range(STEPS):
            tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
            jlog, jc = jdecode(params, jnp.asarray(tok), jc)
            with torch.no_grad():
                tlog, tc = tf.decode_step(model, torch.from_numpy(tok), tc)
            out["decode"].append((np.asarray(jlog), tlog.numpy()))
        out["cache"] = (jax.tree.map(np.asarray, jc), carry.cache_to_jax(tc))
        memo[arch] = out
        return out

    return run


def _caches_close(got: dict, want: dict, h_of_max: bool = False) -> None:
    """Equal keys, shapes and dtypes and index; values within CACHE_TOL
    (``h_of_max``: the SSM state ``h`` within CACHE_TOL of its max |h|)."""
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert got[name].dtype == want[name].dtype, name
        if name == "index":
            assert int(got[name]) == int(want[name])
        elif name == "h" and h_of_max:
            err = np.abs(got[name] - want[name]).max()
            assert err <= CACHE_TOL * np.abs(want[name]).max(), err
        else:
            np.testing.assert_allclose(got[name], want[name], rtol=CACHE_TOL,
                                       atol=CACHE_TOL, err_msg=name)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("arch", jreg.ASSIGNED)
def test_init_cache_matches_reference(arch, ring):
    jcfg = jreg.reduced(jreg.get(arch))
    tcfg = treg.reduced(treg.get(arch))
    for max_len in (7, 50):                # under and over the window 32
        want = jtf.init_cache(jcfg, 3, max_len, ring=ring)
        got = carry.cache_to_jax(tf.init_cache(tcfg, 3, max_len, ring=ring))
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == {
            k: (np.asarray(v).shape, np.asarray(v).dtype)
            for k, v in want.items()}
        assert all(not v.any() for v in got.values())


@pytest.mark.parametrize("arch", jreg.ASSIGNED)
def test_prefill_matches_reference(runs, arch):
    want_logits, logits, want_cache, cache = runs(arch)["prefill"]
    assert logits.shape == (B, runs(arch)["jcfg"].vocab)
    np.testing.assert_allclose(logits, want_logits, rtol=0, atol=LOGIT_ATOL)
    _caches_close(cache, want_cache)


@pytest.mark.parametrize("arch", jreg.ASSIGNED)
def test_teacher_forced_decode_matches_reference(runs, arch):
    run = runs(arch)
    for i, (want, got) in enumerate(run["decode"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"decode step {i}")
    _caches_close(run["cache"][1], run["cache"][0])


@pytest.mark.parametrize("arch", jreg.ASSIGNED)
def test_decode_matches_forward(arch):
    """prefill(S - 1) + decode_step(1 token) == the full forward's last
    logits, through the step builders."""
    cfg = treg.reduced(treg.get(arch))
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    model = tf.init(torch.Generator().manual_seed(0), cfg)
    _, batch = _batches(cfg, seed=7)
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    with torch.no_grad():
        full, _ = tf.forward(model, batch)
        cache = tf.init_cache(cfg, B, _prefix(cfg) + S + 2)
        _, cache = prefill(model, {**batch, "tokens": batch["tokens"][:, :-1]},
                           cache)
        logits, cache = decode(model, batch["tokens"][:, -1], cache)
    assert int(cache["index"]) == _prefix(cfg) + S
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


def _decode_n(decode, model, cache, toks):
    outs = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            logits, cache = decode(model, toks[:, t], cache)
            outs.append(logits)
    return torch.stack(outs, 1).numpy(), cache


def test_ring_matches_full_cache():
    """Window 8, 24 decode tokens (the ring wraps three times): the ring
    buffer's logits equal the full cache's and the reference ring's."""
    jcfg = dataclasses.replace(jreg.reduced(jreg.get("hymba-1.5b")), window=8)
    tcfg = dataclasses.replace(treg.reduced(treg.get("hymba-1.5b")), window=8)
    params = jax.tree.map(np.asarray, jtf.init(jax.random.key(0), jcfg))
    model = carry.transformer_from_jax(params, tcfg)
    n = 24
    toks = np.random.default_rng(1).integers(0, jcfg.vocab,
                                             (B, n)).astype(np.int32)
    full = tf.init_cache(tcfg, B, n + 1)
    ring = tf.init_cache(tcfg, B, n + 1, ring=True)
    assert ring["k"].shape[3] == tcfg.window and full["k"].shape[3] == n + 1
    lf, _ = _decode_n(tf.decode_step, model, full, torch.from_numpy(toks))
    lr, ring = _decode_n(tf.decode_step, model, ring, torch.from_numpy(toks))
    np.testing.assert_allclose(lr, lf, rtol=0, atol=LOGIT_ATOL)
    jring = jtf.init_cache(jcfg, B, n + 1, ring=True)
    jdecode = jax.jit(lambda p, t, c: jtf.decode_step(p, jcfg, t, c))
    want = []
    for t in range(n):
        logits, jring = jdecode(params, jnp.asarray(toks[:, t]), jring)
        want.append(np.asarray(logits))
    np.testing.assert_allclose(lr, np.stack(want, 1), rtol=0, atol=LOGIT_ATOL)
    _caches_close(carry.cache_to_jax(ring), jax.tree.map(np.asarray, jring),
                  h_of_max=True)


def _ssm_pair():
    jcfg = dataclasses.replace(jreg.reduced(jreg.get("falcon-mamba-7b")),
                               d_model=64)
    tcfg = dataclasses.replace(treg.reduced(treg.get("falcon-mamba-7b")),
                               d_model=64)
    rng = np.random.default_rng(6)
    params = jax.tree.map(np.asarray, jssm.ssm_init(jax.random.key(3), jcfg))
    params["dt_bias"] = rng.standard_normal(params["dt_bias"].shape).astype(
        np.float32)
    params["conv_b"] = rng.standard_normal(params["conv_b"].shape).astype(
        np.float32)
    state = {"conv": rng.standard_normal(
                 (B, jcfg.ssm_conv - 1, jcfg.d_inner)).astype(np.float32),
             "h": rng.standard_normal(
                 (B, jcfg.d_inner, jcfg.ssm_state)).astype(np.float32)}
    tparams = {k: carry._to_port(k, v) for k, v in params.items()}
    return jcfg, tcfg, params, tparams, state, rng


def _states_close(got, want):
    for name in ("conv", "h"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=CACHE_TOL, atol=CACHE_TOL,
                                   err_msg=name)


def test_ssm_step_matches_reference():
    jcfg, tcfg, params, tparams, state, rng = _ssm_pair()
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    got, got_state = ssm.ssm_step(
        tparams, tcfg, torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in state.items()})
    want, want_state = jssm.ssm_step(params, jcfg, jnp.asarray(x),
                                     jax.tree.map(jnp.asarray, state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    _states_close(got_state, want_state)


@pytest.mark.parametrize("chunk", [64, 4])
def test_stateful_ssm_apply_matches_reference(chunk):
    """The chunked scan from a carried state, 13 tokens (chunk 4: three
    full chunks and one padded), with its exact final state."""
    jcfg, tcfg, params, tparams, state, rng = _ssm_pair()
    x = rng.standard_normal((B, 13, 64)).astype(np.float32)
    got, got_state = ssm.ssm_apply(
        tparams, tcfg, torch.from_numpy(x), chunk=chunk,
        state={k: torch.from_numpy(v) for k, v in state.items()},
        return_state=True)
    want, want_state = jssm.ssm_apply(
        params, jcfg, jnp.asarray(x), chunk=chunk,
        state=jax.tree.map(jnp.asarray, state), return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    _states_close(got_state, want_state)
    init = ssm.ssm_init_state(tcfg, B)
    want_init = jssm.ssm_init_state(jcfg, B)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in init.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in want_init.items()}
