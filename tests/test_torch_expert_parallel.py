"""The port's MoE expert parallelism, remat and train step against the
reference's, on the CPU.

* ``_sort_dispatch`` equal to the reference's (buffer, slots, kept rows)
  on ids with invalid entries and overflowing buckets.
* ``moe_apply_ep`` on a one-rank (data=1, model=1) mesh against the
  reference's on its one-device host mesh, for the three MoE archs
  (reduced) at the default capacity and at 8.0: within the reference's
  2e-4 (tests/test_moe.py), the aux within 1e-5; against the port's own
  ``moe_apply`` where neither drops a pair.  ``enable_expert_parallel``
  routes ``moe_apply`` through it and ``disable_expert_parallel`` back.
* At R = 2, two gloo ranks on a (data=2, model=1) mesh, each with half
  the tokens and the whole stacks (sliced inside), against the reference's
  ``moe_apply_ep`` on the same mesh shape in a JAX subprocess on forced host
  devices (tests/_sharded_reference.py): the outputs within 2e-4, the aux
  within 1e-5, no pair dropped; the gradients finite and non-zero, and
  the ranks' expert gradients summed equal to one rank's gradient through
  the dense layer.
* ``remat``: loss and every gradient equal with and without it (the
  recomputed forward is the same arithmetic), and the loss held to the
  reference's ``loss_fn(remat=True)`` within 1e-5 relative, for a dense,
  a hybrid, an MoE and the encoder-decoder arch; ``make_train_step``
  defaults to remat, as the reference, and the pretrain CLI runs it off,
  as the reference's ``run_pretrain`` does.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.mesh import make_host_mesh
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import carry
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.testing import cap_cpu_threads, run_ranks

import _torch_sharded_ranks as ranks

cap_cpu_threads()

MOE_ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]
EP_TOL = 2e-4
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _moe_pair(arch, cf=None):
    rep = {} if cf is None else {"capacity_factor": cf}
    jcfg = dataclasses.replace(jreg.reduced(jreg.get(arch)), **rep)
    tcfg = dataclasses.replace(treg.reduced(treg.get(arch)), **rep)
    params = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(5), jcfg))
    tparams = {k: carry._to_port(k, v, "moe") for k, v in params.items()}
    return jcfg, tcfg, params, tparams


def _x(cfg, b=4, s=24, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def test_sort_dispatch_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    ids = rng.integers(-1, 3, 40)
    ids[:12] = 1                                  # overflows bucket 1
    want = jmoe._sort_dispatch(jnp.asarray(x), jnp.asarray(ids, jnp.int32),
                               3, 6)
    got = moe._sort_dispatch(torch.from_numpy(x), torch.from_numpy(ids), 3,
                             6)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    keep = np.asarray(want[2])
    np.testing.assert_array_equal(got[2].numpy(), keep)
    np.testing.assert_array_equal(got[1].numpy()[keep],
                                  np.asarray(want[1])[keep])


@pytest.mark.parametrize("cf", [None, 8.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ep_one_rank_matches_reference(arch, cf):
    jcfg, tcfg, params, tparams = _moe_pair(arch, cf)
    x = _x(jcfg)
    jmesh = make_host_mesh()
    with jmesh:        # jitted: eager shard_map is ~10x slower here
        want, want_aux = jax.jit(lambda p, x_: jmoe.moe_apply_ep(
            p, jcfg, x_, mesh=jmesh))(params, jnp.asarray(x))
    stats = {}
    got, aux = moe.moe_apply_ep(tparams, tcfg, torch.from_numpy(x),
                                mesh=mesh_lib.parse_mesh("data=1,model=1"),
                                stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=EP_TOL,
                               atol=EP_TOL)
    assert abs(float(aux) - float(want_aux)) <= 1e-5
    dense, dense_aux = moe.moe_apply(tparams, tcfg, torch.from_numpy(x))
    t = x.shape[0] * x.shape[1]
    keep = moe.dispatch(tparams, tcfg, torch.from_numpy(x).reshape(t, -1),
                        moe.capacity(tcfg, t)).keep
    if stats["dropped"] == 0 and bool(keep.all()):
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert abs(float(aux) - float(dense_aux)) <= 1e-5


def test_enable_expert_parallel_routes(monkeypatch):
    _, tcfg, _, tparams = _moe_pair(MOE_ARCHS[0], 8.0)
    x = torch.from_numpy(_x(tcfg))
    calls = []
    original = moe.moe_apply_ep

    def counting(*a, **k):
        calls.append(k["mesh"])
        return original(*a, **k)

    monkeypatch.setattr(moe, "moe_apply_ep", counting)
    mesh = mesh_lib.parse_mesh("data=1,model=1")
    moe.enable_expert_parallel(mesh)
    try:
        got, _ = moe.moe_apply(tparams, tcfg, x)
    finally:
        moe.disable_expert_parallel()
    assert calls == [mesh]
    dense, _ = moe.moe_apply(tparams, tcfg, x)
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_ep_grads_match_dense_one_rank():
    _, tcfg, _, tparams = _moe_pair(MOE_ARCHS[0], 8.0)
    x = _x(tcfg)
    grads = []
    for ep in (True, False):
        p = {k: v.clone().requires_grad_() for k, v in tparams.items()}
        xt = torch.from_numpy(x).requires_grad_()
        if ep:
            out, aux = moe.moe_apply_ep(
                p, tcfg, xt, mesh=mesh_lib.parse_mesh("data=1,model=1"))
        else:
            out, aux = moe.moe_apply(p, tcfg, xt)
        (out.square().sum() + aux).backward()
        grads.append({**{k: v.grad for k, v in p.items()}, "x": xt.grad})
    for k, g in grads[0].items():
        assert torch.isfinite(g).all() and g.abs().sum() > 0, k
        np.testing.assert_allclose(g.numpy(), grads[1][k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """moe_apply_ep at R = 2: the port's gloo ranks and the reference in a
    JAX subprocess, on the same inputs (reduced moonshot, 4 x 24 tokens,
    capacity 8.0)."""
    jcfg, tcfg, params, tparams = _moe_pair(MOE_ARCHS[0], 8.0)
    x = _x(jcfg)
    inp = {"arch": MOE_ARCHS[0], "cf": 8.0, "x": x,
           **{f"param/{k}": v for k, v in params.items()},
           **{f"tparam/{k}": v.numpy() for k, v in tparams.items()}}
    tmp = tmp_path_factory.mktemp("ep")
    src, dst = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(src, **inp)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH",
                                                              "")]))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_sharded_reference.py"), "moe",
         src, dst], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        got = run_ranks(ranks.moe_ep, 2, inp)
        log, _ = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    return got, dict(np.load(dst)), tcfg, tparams, x


def test_ep_two_ranks_match_reference(two_ranks):
    got, ref, _, _, _ = two_ranks
    out = np.concatenate([g["out"] for g in got])
    np.testing.assert_allclose(out, ref["ep/out"], rtol=EP_TOL, atol=EP_TOL)
    np.testing.assert_allclose(out, ref["dense/out"], rtol=EP_TOL,
                               atol=EP_TOL)
    for g in got:
        assert abs(g["aux"] - float(ref["ep/aux"])) <= 1e-5
        assert g["dropped"] == 0


def test_ep_two_ranks_grads(two_ranks):
    """Finite, non-zero, and summed over the ranks (each rank's loss is
    over its own tokens) equal to the dense layer's gradient of the whole
    batch's loss, with the aux loss counted once per rank."""
    got, _, tcfg, tparams, x = two_ranks
    p = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    out, aux = moe.moe_apply(p, tcfg, torch.from_numpy(x))
    (out.square().sum() + 2 * aux).backward()
    for k in p:
        for g in got:
            assert np.isfinite(g["grads"][k]).all()
            assert np.abs(g["grads"][k]).sum() > 0, k
        summed = sum(g["grads"][k] for g in got)
        np.testing.assert_allclose(summed, p[k].grad.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


# -- remat ------------------------------------------------------------------------

REMAT_ARCHS = ["starcoder2-7b", "hymba-1.5b", "moonshot-v1-16b-a3b",
               "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_loss_and_grads(arch):
    jcfg, tcfg = jreg.reduced(jreg.get(arch)), treg.reduced(treg.get(arch))
    params = jtf.init(jax.random.key(0), jcfg)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
    jbatch, batch = {"tokens": jnp.asarray(tokens)}, \
        {"tokens": torch.from_numpy(tokens)}
    if jcfg.modality:
        modal = rng.standard_normal(
            (2, jcfg.n_modal_tokens, jcfg.d_modal)).astype(np.float32)
        jbatch["modal"], batch["modal"] = jnp.asarray(modal), \
            torch.from_numpy(modal)
    want = float(jtf.loss_fn(params, jcfg, jbatch, remat=True))
    model = carry.transformer_from_jax(jax.tree.map(np.asarray, params), tcfg)
    named = dict(model.named_parameters())
    out = []
    for remat in (False, True):
        loss = tf.loss_fn(model, batch, remat=remat)
        # the decoder's unused leaves (an encoder-decoder's modal projector
        # is the encoder's) get no gradient on either path
        out.append((float(loss.detach()), torch.autograd.grad(
            loss, list(named.values()), allow_unused=True)))
    (plain, g_plain), (rem, g_rem) = out
    assert rem == plain
    for name, a, b in zip(named, g_plain, g_rem):
        assert (a is None and b is None) or torch.equal(a, b), name
    assert abs(rem - want) <= 1e-5 * abs(want)


def test_make_train_step_remat_default():
    cfg = treg.reduced(treg.get("starcoder2-7b"))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 17)))
    losses = []
    for kw in ({}, {"remat": False}):
        model = tf.init(torch.Generator().manual_seed(0), cfg)
        step, opt = steps.make_train_step(cfg, optimizer="adam", lr=1e-3,
                                          **kw)
        state = opt.init(dict(model.named_parameters()))
        losses.append([float(step(model, state, {"tokens": toks}))
                       for _ in range(3)])
    assert losses[0] == losses[1]


def test_pretrain_cli_runs_without_remat(monkeypatch):
    seen = []
    original = steps.make_train_step

    def recording(cfg, **kw):
        seen.append(kw.get("remat"))
        return original(cfg, **kw)

    monkeypatch.setattr(steps, "make_train_step", recording)
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        ttrain.main(["--mode", "pretrain", "--device", "cpu", "--reduced",
                     "--steps", "2", "--lr", "1e-3", "--arch",
                     "starcoder2-7b", "--seq-len", "16", "--batch-size",
                     "2"])
    assert seen == [False]
