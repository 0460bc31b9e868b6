"""The port's LM pretraining step, optimizers and ``--mode pretrain`` CLI
against the reference's, on the CPU.

- Three steps of ``make_train_step`` at the reduced hymba-1.5b (f32) and
  the reduced seamless-m4t-large-v2 (with a seeded ``modal`` input), with
  Adam and with SGD momentum 0.9, from the reference's init carried across
  and on the same ``lm_tokens`` batches: losses within 1e-3 relative, the
  parameters' moves within 1e-3 of the reference's norm, and seamless's
  unread top-level projector unmoved in both.
- ``adam``, ``adamw`` and ``sgd(momentum, nesterov)`` against the
  reference's on random trees over three steps: f32 leaves within 1e-6;
  bf16 leaves (SGD keeps them bf16) within one bf16 step of the leaf's
  largest value, 2**-7 of its max, since JAX rounds a Python scalar to the
  array's bf16 before multiplying and torch multiplies by it in f32; the
  in-place ``step`` equal to ``update`` plus ``apply_updates``.
- The CLI on ``--device cpu --reduced``: the reference's keys plus
  ``device``, the loss falls; without ``--device cpu`` and with no card it
  exits non-zero.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import optimizers as jopt
from repro_torch import carry
from repro_torch.configs import registry as treg
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.optim import optimizers as topt
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("arch,optimizer", [
    pytest.param("hymba-1.5b", "adam", id="adam"),
    pytest.param("hymba-1.5b", "sgd", id="sgd"),
    pytest.param("seamless-m4t-large-v2", "adam", id="seamless-adam"),
    pytest.param("seamless-m4t-large-v2", "sgd", id="seamless-sgd")])
def test_train_steps_match_reference(arch, optimizer):
    jcfg = jreg.reduced(jreg.get(arch))
    tcfg = treg.reduced(treg.get(arch))
    params = jtf.init(jax.random.key(0), jcfg)
    model = carry.transformer_from_jax(jax.tree.map(np.asarray, params), tcfg)
    toks = jsyn.lm_tokens(3 * 2, 33, jcfg.vocab, seed=1)
    # the encoder-decoder family's encoder input, seeded
    modal = (np.random.default_rng(2).standard_normal(
        (3 * 2, jcfg.n_modal_tokens, jcfg.d_modal)).astype(np.float32)
        if jcfg.modality else None)
    jstep, jo = jsteps.make_train_step(jcfg, optimizer=optimizer, lr=1e-3,
                                       remat=False)
    tstep, to = tsteps.make_train_step(tcfg, optimizer=optimizer, lr=1e-3,
                                       remat=False)
    jstate = jo.init(params)
    tstate = to.init(dict(model.named_parameters()))
    jstep = jax.jit(jstep)
    for i in range(3):
        jbatch = {"tokens": jnp.asarray(toks[2 * i:2 * i + 2])}
        tbatch = {"tokens": torch.from_numpy(toks[2 * i:2 * i + 2])}
        if modal is not None:
            jbatch["modal"] = jnp.asarray(modal[2 * i:2 * i + 2])
            tbatch["modal"] = torch.from_numpy(modal[2 * i:2 * i + 2])
        params, jstate, jloss = jstep(params, jstate, jbatch)
        tloss = tstep(model, tstate, tbatch)
        assert abs(float(tloss) - float(jloss)) <= 1e-3 * abs(float(jloss))
    # the parameters moved the same way: Adam's update of a coordinate
    # whose gradient is near 0 is about ±lr whatever the gradient's size,
    # so the moves are compared as whole vectors
    init_tree = jax.tree.map(np.asarray, jtf.init(jax.random.key(0), jcfg))
    init = jax.tree.leaves(init_tree)
    port = carry.transformer_to_jax(model)
    moved_port = np.concatenate([(a - i).ravel() for a, i in zip(
        jax.tree.leaves(port), init)])
    moved_ref = np.concatenate([(np.asarray(b) - i).ravel() for b, i in zip(
        jax.tree.leaves(params), init)])
    assert (np.linalg.norm(moved_port - moved_ref)
            <= 1e-3 * np.linalg.norm(moved_ref))
    if jcfg.enc_dec:
        # the top-level modal projector, which the loss does not read (the
        # encoder has its own): jax.grad gives it zeros, and neither
        # optimizer moves it, in the reference or in the port
        np.testing.assert_array_equal(np.asarray(params["proj"]),
                                      init_tree["proj"])
        np.testing.assert_array_equal(port["proj"], init_tree["proj"])


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(7).astype(ml_dtypes.bfloat16)}


def _torch_tree(tree):
    return {k: torch.from_numpy(v.astype(np.float32)).to(
        torch.bfloat16 if v.dtype == ml_dtypes.bfloat16 else torch.float32)
        for k, v in tree.items()}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("name,kw", [
    ("adam", {}), ("adamw", {"weight_decay": 0.1}),
    ("sgd", {"momentum": 0.9}), ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("sgd", {})])
def test_optimizers_match_reference(name, kw):
    jo = getattr(jopt, name)(0.05, **kw)
    to = getattr(topt, name)(0.05, **kw)
    jp = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    tp = _torch_tree(_tree(0))
    tp_inplace = {k: v.clone() for k, v in tp.items()}
    js, ts = jo.init(jp), to.init(tp)
    ts_inplace = to.init(tp_inplace)
    for i in range(3):
        grads = _tree(10 + i)
        jg = {k: jnp.asarray(v) for k, v in grads.items()}
        tg = _torch_tree(grads)
        ju, js = jo.update(jg, js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(tg, ts, tp)
        tp = topt.apply_updates(tp, tu)
        to.step(tp_inplace, tg, ts_inplace)
        for k in jp:
            assert tp[k].dtype == tp_inplace[k].dtype == (
                torch.bfloat16 if k == "b" else torch.float32)
            pairs = [(tu[k], ju[k]), (tp[k], jp[k])]
            pairs += [(ts[slot][k], js[slot][k])
                      for slot in {"m", "v", "mu"} & set(ts)]
            for got, want in pairs:
                got, want = _np(got), _np(want)
                if tp[k].dtype == torch.bfloat16:
                    atol = 2**-7 * np.abs(want).max()
                    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-6,
                                               atol=1e-6)
            assert torch.equal(tp[k], tp_inplace[k])
            for slot in {"m", "v", "mu"} & set(ts):
                assert torch.equal(ts[slot][k], ts_inplace[slot][k])


def test_plain_sgd_keeps_no_state():
    """The FL clients' optimizer: no momentum, an empty state, -lr * g."""
    opt = topt.sgd(0.01)
    g = {"w": torch.tensor([1.0, -2.0])}
    upd, state = opt.update(g, opt.init(g), g)
    assert state == {}
    assert torch.equal(upd["w"], -0.01 * g["w"])


def test_pretrain_cli_on_cpu(capsys):
    out = ttrain.main(["--mode", "pretrain", "--device", "cpu", "--reduced",
                       "--steps", "4", "--lr", "1e-3", "--flash"])
    printed = json.loads(capsys.readouterr().out.split("\n{", 1)[1]
                         .rsplit("}", 1)[0].join("{}"))
    assert set(printed) == {"mode", "arch", "losses", "loss_first",
                            "loss_last", "wall_s", "device"}
    assert printed["device"] == "cpu" and printed["arch"] == "hymba-1.5b-reduced"
    assert out["loss_last"] < out["loss_first"]
    assert len(out["step_s"]) == len(out["losses"]) == 4


def test_pretrain_cli_without_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mode",
         "pretrain", "--reduced", "--steps", "1"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert proc.stdout == ""
