"""The SSM scan as one registered operator
(``repro_torch.models.ssm_scan``: ``torch.ops.repro_torch.ssm_scan`` and
its backward).

* The op's ``y`` and ``h_last`` equal the chunk loop's
  (``repro_torch.testing.ssm_chunk_loop``, the loop ``ssm_apply`` ran
  inline before) bit for bit: at chunk 64 over whole chunks, at a ragged S
  and from a carried h0; its carries are the loop's state at each chunk's
  start; with ``save`` off the carries are empty.
* Its gradients: ``torch.autograd.gradcheck`` in f64; in f32 within 1e-5
  of the max of autograd through the chunk loop.
* ``ssm_apply`` at a reduced falcon-mamba-7b (d_model 32: d_inner 64,
  N = 16), forward within 1e-5 (rtol = atol, as
  ``tests/test_torch_transformer.py``) and every parameter's gradient
  within 1e-5 of its max (the reference's gradient through ``lax.scan``
  and the op's written-out reverse scan sum in different orders; they
  differ by at most 4.9e-7 of the max here) of ``jax.grad`` of
  ``repro.models.ssm.ssm_apply``.
* Under ``FakeTensorMode`` a layer's scan is one op forward and one
  backward, and the dry-run's counter gives the op the FLOPs, bytes and
  peak of a counter run of its body.
* On a (4, 4) fake mesh (a subprocess, ``tests/_torch_dryrun_cases.py``)
  the op partitions under its own sharding rule: a rank counts 1/16 of the
  unsharded FLOPs, with no fallback and no collective; a train step of the
  reduced falcon-mamba-7b at S = 4096 traces well within its limit.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jreg
from repro.models import ssm as jssm
from repro_torch import carry
from repro_torch.configs import registry as treg
from repro_torch.launch import analysis
from repro_torch.models import ssm, ssm_scan
from repro_torch.testing import cap_cpu_threads, ssm_chunk_loop

cap_cpu_threads()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SCAN = torch.ops.repro_torch.ssm_scan.default
SCAN_BACKWARD = torch.ops.repro_torch.ssm_scan_backward.default


def _inputs(b, s, di, n, *, seed=0, dtype=torch.float32, carried=True):
    """delta (softplus of a normal, as the layer makes it), u, bmat, cmat,
    a = -(1..N)/10 per row, h0 (zeros unless ``carried``), from numpy."""
    rng = np.random.default_rng(seed)
    delta = np.logaddexp(0.0, rng.standard_normal((b, s, di)))
    a = -np.tile(np.arange(1, n + 1), (di, 1)) / 10.0
    h0 = (rng.standard_normal((b, di, n)) if carried
          else np.zeros((b, di, n)))
    arrays = [delta, rng.standard_normal((b, s, di)),
              rng.standard_normal((b, s, n)), rng.standard_normal((b, s, n)),
              a, h0]
    return [torch.from_numpy(np.asarray(x)).to(dtype) for x in arrays]


#: (B, S, d_inner, N, chunk, carried h0)
CASES = [(2, 128, 64, 16, 64, False),      # whole chunks
         (2, 200, 64, 16, 64, False),      # ragged: 3 chunks and 8 steps
         (1, 70, 32, 16, 64, True),        # from a carried state
         (2, 5, 16, 16, 64, True)]         # one chunk shorter than 64


@pytest.mark.parametrize("b,s,di,n,chunk,carried", CASES)
def test_forward_is_the_chunk_loop_bit_for_bit(b, s, di, n, chunk, carried):
    xs = _inputs(b, s, di, n, carried=carried)
    with torch.no_grad():
        want_y, want_h = ssm_chunk_loop(*xs, chunk)
        y, h, carries = SCAN(*xs, chunk, False)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert carries.shape == (b, 0, di, n)
    # with grad on: the same values, and the state at each chunk's start
    leaves = [x.clone().requires_grad_() for x in xs]
    y, h, carries = SCAN(*leaves, chunk, True)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    step = min(chunk, s)
    assert carries.shape == (b, -(-s // step), di, n)
    start = xs[5]
    for c in range(carries.shape[1]):
        assert torch.equal(carries[:, c], start), c
        with torch.no_grad():
            _, start = ssm_chunk_loop(
                *[t[:, c * step:(c + 1) * step] for t in xs[:4]], xs[4],
                start, chunk)


def test_gradcheck_f64():
    xs = [x.requires_grad_() for x in _inputs(2, 11, 4, 3,
                                               dtype=torch.float64)]
    assert torch.autograd.gradcheck(
        lambda *t: SCAN(*t, 4, True)[:2], xs)


@pytest.mark.parametrize("b,s,di,n,chunk,carried", [(2, 200, 32, 16, 64,
                                                      False), CASES[2]])
def test_gradients_match_autograd_through_the_loop(b, s, di, n, chunk,
                                                   carried):
    xs = _inputs(b, s, di, n, carried=carried)
    rng = np.random.default_rng(1)
    gy = torch.from_numpy(rng.standard_normal((b, s, di))).float()
    gh = torch.from_numpy(rng.standard_normal((b, di, n))).float()
    grads = []
    for run in (ssm_chunk_loop, ssm_scan.scan):
        leaves = [x.clone().requires_grad_() for x in xs]
        y, h = run(*leaves, chunk)
        grads.append(torch.autograd.grad((y, h), leaves, (gy, gh)))
    for name, want, got in zip(("delta", "u", "bmat", "cmat", "a", "h0"),
                               *grads):
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (name, err)


def test_backward_without_the_carries_raises():
    xs = _inputs(1, 8, 4, 2)
    y, h, carries = SCAN(*xs, 4, False)
    with pytest.raises(RuntimeError, match="save=True"):
        torch.ops.repro_torch.ssm_scan_backward(y, h, *xs[:5], carries, 4)


def _ssm_pair():
    jcfg = jreg.reduced(jreg.get("falcon-mamba-7b"), d_model=32)
    tcfg = treg.reduced(treg.get("falcon-mamba-7b"), d_model=32)
    assert (tcfg.d_inner, tcfg.ssm_state) == (64, 16)
    params = jax.tree.map(np.asarray, jssm.ssm_init(jax.random.key(3), jcfg))
    rng = np.random.default_rng(6)
    for k in ("dt_bias", "conv_b"):
        params[k] = rng.standard_normal(params[k].shape).astype(np.float32)
    return jcfg, tcfg, params, rng


def test_ssm_apply_and_its_gradients_match_reference():
    """S = 70 with chunk 64: two chunks, the second padded by 58 steps."""
    jcfg, tcfg, params, rng = _ssm_pair()
    x = rng.standard_normal((2, 70, 32)).astype(np.float32)
    w = rng.standard_normal((2, 70, 32)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jssm.ssm_apply(p, jcfg, jnp.asarray(x), chunk=64) * w)

    want_grads = jax.grad(jloss)(params)
    want = jssm.ssm_apply(params, jcfg, jnp.asarray(x), chunk=64)
    tparams = {k: carry._to_port(k, v).requires_grad_()
               for k, v in params.items()}
    got = ssm.ssm_apply(tparams, tcfg, torch.from_numpy(x), chunk=64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                list(tparams.values()))
    for (k, g) in zip(tparams, grads):
        ref = carry._to_port(k, want_grads[k]).numpy()
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= 1e-5 * float(np.abs(ref).max()), (k, err)


class _Ops(TorchDispatchMode):
    """The ops a block dispatches, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_a_layers_scan_is_one_op_under_fake_tensors():
    _, tcfg, params, rng = _ssm_pair()
    with FakeTensorMode():
        tparams = {k: torch.empty(carry._to_port(k, v).shape)
                   .requires_grad_() for k, v in params.items()}
        x = torch.empty((2, 200, 32))
        with _Ops() as ops:
            out = ssm.ssm_apply(tparams, tcfg, x, chunk=64)
            torch.autograd.grad(out.sum(), list(tparams.values()))
    assert ops.names.count("repro_torch.ssm_scan.default") == 1
    assert ops.names.count("repro_torch.ssm_scan_backward.default") == 1
    # the body's step ops stay inside the op
    assert not any("addcmul" in name or "bmm" in name for name in ops.names)


def _count(fn, inputs):
    """(FLOPs, bytes, peak bytes) of ``fn(*inputs)`` by the dry-run's
    counter, the inputs held."""
    c = analysis.Counter()
    c.hold(inputs)
    with c:
        fn(*inputs)
    return c.flops, c.bytes, c.peak_bytes


def _fwd_bwd(run, chunk):
    """``run`` (the op or the inline loop) forward and backward."""
    def fn(*leaves):
        y, h = run(*leaves, chunk)
        torch.autograd.grad((y, h), leaves,
                            (torch.empty(y.shape), torch.empty(h.shape)))
    return fn


@pytest.mark.parametrize("b,s,di,n,chunk", [(2, 200, 64, 16, 64),
                                            (1, 70, 32, 16, 64),
                                            (2, 5, 16, 16, 64),
                                            (2, 130, 8, 2, 32)])
def test_counter_counts_the_op_as_its_body(b, s, di, n, chunk):
    """The counter's bytes and peak for the forward op, and for the
    backward op, equal a counter run of the body's own ops; its FLOPs, of
    the forward and of the forward and backward, equal the registry's
    count of the chunk loop run inline (a step's FLOPs unchanged by the
    op)."""
    with FakeTensorMode():
        xs = [torch.empty(shape) for shape in
              ((b, s, di), (b, s, di), (b, s, n), (b, s, n), (di, n),
               (b, di, n))]
        for save in (False, True):
            op = _count(lambda *t: SCAN(*t, chunk, save), xs)
            body = _count(lambda *t: ssm_scan.scan_forward(*t, chunk, save),
                          xs)
            assert op == body
        _, _, carries = ssm_scan.scan_forward(*xs, chunk, True)
        ins = [torch.empty((b, s, di)), torch.empty((b, di, n)), *xs[:5],
               carries]
        op = _count(lambda *t: SCAN_BACKWARD(*t, chunk), ins)
        body = _count(lambda *t: ssm_scan.scan_backward(*t, chunk), ins)
        assert op[1:] == body[1:]
        leaves = [torch.empty(x.shape).requires_grad_() for x in xs]
        assert _count(_fwd_bwd(ssm_scan.scan, chunk), leaves)[0] == \
            _count(_fwd_bwd(ssm_chunk_loop, chunk), leaves)[0]


def _case(name):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.join(HERE,
                                                     "_torch_dryrun_cases.py"),
                        name], capture_output=True, text=True, timeout=180,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_scan_partitions_under_its_own_rule_on_a_fake_mesh():
    out = _case("ssm_scan_mesh")
    assert out["rank_flops"] * 16 == out["whole_flops"] > 0
    assert out["resharded"] == {} and out["collective_bytes"] == 0
    assert out["y"] == ["Shard(dim=0)", "Shard(dim=2)"]
    assert out["h_last"] == ["Shard(dim=0)", "Shard(dim=1)"]
    # delta, u, bmat, cmat, a, h0: bmat's and cmat's gradients partial over
    # model, a's over data
    assert out["grads"][2] == out["grads"][3] == ["Shard(dim=0)",
                                                  "Partial(sum)"]
    assert out["grads"][4] == ["Partial(sum)", "Shard(dim=0)"]


def test_ssm_train_step_at_4k_traces_within_its_limit():
    """The dry-run's fault before the scan was an op: an SSM train step at
    S = 4096 ran L x S dispatched steps and timed out.  The reduced
    falcon-mamba-7b's now traces in seconds, with no fallback."""
    out = _case("ssm_train_4k")
    assert out["status"] == "ok" and out["flops"] > 0
    assert out["trace_s"] < out["limit_s"] / 4
    assert out["resharded"] == {}
