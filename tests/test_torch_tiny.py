"""The port's ``transformer_tiny`` (bf16 parameters, an int32 ``pos_ids``
buffer) against ``repro.models.tiny_transformer``, on carried weights.

- Forward and loss: both compute in f32 from the same bf16 values, so the
  logits agree within 1e-5 of their max and the loss within 1e-5
  relative.
- The geometry: W's columns are the reference's ``client_matrix`` columns
  in order, bf16, D = 27,626, ``pos_ids`` excluded; ``unflatten`` and
  ``matrix_to_stacked`` carry the buffer through untouched.
- One client's local update (6 SGD steps, its batch order injected): bf16
  parameters within 4 bf16 ulps of each leaf's max (2**-5 of it) of the
  reference's.  The f32 math matches to ~1e-6, but each step rounds the
  parameters to bf16 and a value near a rounding boundary can land one
  ulp apart, after which the two trajectories differ by ulps (~4% of the
  values differ, the worst by 1.8 ulps of the max), so the bound is a
  bf16 one.
- One coalition round on a bf16 (10, 27,626) W of three well-separated
  clusters (no tie, ROADMAP C.2): the port's ``stream`` round against the
  reference's ``coalitions.run_round`` — equal assignments and centers,
  barycenters and θ within 1e-5 of their max.
- ``train --model transformer_tiny --device cpu``: W stays bf16 through a
  run, the buffer is untouched, and the ``cuda`` backend (its kernels'
  plain versions on the CPU) equals ``stream``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as jclient
from repro.core import coalitions as jco
from repro.core import pytree as jpt
from repro.models import tiny_transformer as jtt
from repro.models import zoo as jzoo
from repro_torch import carry
from repro_torch.core import client as tclient
from repro_torch.core import coalitions as tco
from repro_torch.core import pytree
from repro_torch.launch import train as ttrain
from repro_torch.models import tiny_transformer as ttt
from repro_torch.models import zoo
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

LOGIT_TOL = 1e-5
#: a bf16 ulp is 2**-7 of the leading power of two; four of them
UPDATE_TOL = 4 * 2.0 ** -7
ROUND_TOL = 1e-5
D = 27_626


def _ref_params(seed=0):
    return jtt.init(jax.random.key(seed))


def _images(n=8, seed=0):
    return np.random.default_rng(seed).random((n, 28, 28, 1),
                                              dtype=np.float32)


def test_zoo_entry():
    assert "transformer_tiny" in zoo.available_models()
    assert zoo.available_models() == jzoo.available_models()
    model = zoo.make_model("transformer_tiny")
    params = model.init(torch.Generator().manual_seed(0))
    assert params["pos_ids"].dtype == torch.int32
    assert all(v.dtype == torch.bfloat16 for k, v in params.items()
               if k != "pos_ids")
    want = _ref_params()
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in carry.params_from_jax(
            want, ttt.REF_LAYOUT).items()}


def test_forward_and_loss_match_reference():
    jp = _ref_params(1)
    tp = carry.params_from_jax(jp, ttt.REF_LAYOUT)
    x = _images()
    y = np.arange(8, dtype=np.int32) % 10
    want = np.asarray(jtt.apply(jp, jnp.asarray(x)))
    got = ttt.apply(tp, torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=LOGIT_TOL)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    np.testing.assert_allclose(
        float(ttt.loss_fn(tp, {"x": torch.from_numpy(x),
                               "y": torch.from_numpy(y)})),
        float(jtt.loss_fn(jp, batch)), rtol=1e-5)
    np.testing.assert_allclose(
        float(ttt.accuracy(tp, torch.from_numpy(x), torch.from_numpy(y))),
        float(jtt.accuracy(jp, jnp.asarray(x), jnp.asarray(y))))


def test_geometry_is_the_reference_s():
    jp = _ref_params(2)
    tp = carry.params_from_jax(jp, ttt.REF_LAYOUT)
    jw = jpt.client_matrix(jax.tree.map(lambda l: l[None], jp))
    tw = pytree.client_matrix({k: v[None] for k, v in tp.items()},
                              ttt.REF_LAYOUT)
    assert tw.shape == (1, D) and tw.dtype == torch.bfloat16
    assert jw.shape == (1, D) and jw.dtype == jnp.bfloat16
    np.testing.assert_array_equal(tw.float().numpy(),
                                  np.asarray(jw.astype(jnp.float32)))
    # the buffer rides through unflatten and matrix_to_stacked untouched
    vec = torch.arange(D, dtype=torch.float32).to(torch.bfloat16)
    back = pytree.unflatten(vec, ttt.REF_LAYOUT, tp)
    assert torch.equal(back["pos_ids"], tp["pos_ids"])
    assert torch.equal(pytree.flatten(back, ttt.REF_LAYOUT), vec)
    jback = jpt.unflatten(jnp.asarray(vec.float().numpy()).astype(
        jnp.bfloat16), jp)
    for k, v in carry.params_from_jax(jback, ttt.REF_LAYOUT).items():
        assert torch.equal(v, back[k]), k
    stacked = pytree.matrix_to_stacked(vec[None].expand(3, -1),
                                       ttt.REF_LAYOUT, tp)
    assert stacked["pos_ids"].shape == (3, 28)
    assert torch.equal(stacked["pos_ids"][2], tp["pos_ids"])
    # the checkpoint naming covers the buffer and the block list
    tree = pytree.to_ref_tree(tp, ttt.REF_LAYOUT)
    assert tree["pos_ids"].dtype == torch.int32 and "0" in tree["blocks"]


def test_local_update_matches_reference():
    jp = _ref_params(3)
    tp = carry.params_from_jax(jp, ttt.REF_LAYOUT)
    x = _images(12, seed=1)
    y = (np.arange(12) % 10).astype(np.int32)
    cfg = dict(epochs=2, batch_size=4, lr=0.05)
    key = jax.random.key(4)
    ref, ref_loss = jclient.client_update(
        jtt.loss_fn, jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, key,
        jclient.ClientConfig(**cfg))
    perms = torch.from_numpy(np.stack([
        np.asarray(jax.random.permutation(ek, 12))
        for ek in jax.random.split(key, 2)]))
    got, loss = tclient.client_update(
        ttt.loss_fn, tp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        perms, tclient.ClientConfig(**cfg))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    want = carry.params_from_jax(ref, ttt.REF_LAYOUT)
    assert torch.equal(got["pos_ids"], tp["pos_ids"])
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        scale = float(v.float().abs().max()) + 1e-12
        err = float((got[k].float() - v.float()).abs().max())
        assert err <= UPDATE_TOL * scale, (k, err, scale)


def _clustered_w(n=10, k=3, seed=0):
    """θ of a carried init plus one of k well-separated offsets per client
    and a small per-client jitter, in bf16."""
    theta = jpt.flatten(_ref_params(5)).astype(jnp.float32)
    rng = np.random.default_rng(seed)
    offsets = rng.standard_normal((k, D)).astype(np.float32)
    members = np.arange(n) % k
    w = (np.asarray(theta)[None] + offsets[members]
         + 0.05 * rng.standard_normal((n, D)).astype(np.float32))
    return jnp.asarray(w).astype(jnp.bfloat16), members


def test_coalition_round_on_bf16_w_matches_reference():
    w, members = _clustered_w()
    center_idx = np.array([0, 4, 8])       # one center per cluster
    ref = jco.run_round(w, jco.CoalitionState(
        center_idx=jnp.asarray(center_idx, jnp.int32), round=jnp.int32(0)),
        backend="xla")
    tw = torch.from_numpy(np.array(w.astype(jnp.float32))).to(
        torch.bfloat16)
    got = tco.run_round(tw, tco.CoalitionState(
        center_idx=torch.from_numpy(center_idx), round=0), backend="stream")
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(ref.assignment))
    np.testing.assert_array_equal(got.assignment.numpy(), members)
    np.testing.assert_array_equal(got.new_center_idx.numpy(),
                                  np.asarray(ref.new_center_idx))
    for field in ("barycenters", "theta"):
        want = np.asarray(getattr(ref, field), np.float64)
        val = getattr(got, field).float().numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(val / scale, want / scale, rtol=0,
                                   atol=ROUND_TOL, err_msg=field)


@pytest.mark.parametrize("backend", ["stream", "cuda"])
def test_cli_runs_bf16_w(backend, capsys):
    args = ["--mode", "fl", "--device", "cpu", "--model", "transformer_tiny",
            "--rounds", "2", "--clients", "4", "--coalitions", "2",
            "--local-epochs", "1", "--n-train", "200", "--n-test", "50",
            "--backend", backend]
    out = ttrain.main(args)
    capsys.readouterr()
    assert out["model"] == "transformer_tiny" and out["device"] == "cpu"
    assert all(np.isfinite(out["test_acc"]))
    params = out["params"]
    assert params["pos_ids"].dtype == torch.int32
    assert torch.equal(params["pos_ids"], torch.arange(28, dtype=torch.int32))
    w = pytree.flatten(params, ttt.REF_LAYOUT)
    assert w.dtype == torch.bfloat16 and w.shape == (D,)
    if backend == "cuda":
        ref = ttrain.main(args[:-1] + ["stream"])
        capsys.readouterr()
        assert out["test_acc"] == ref["test_acc"]
        assert out["final_assignment"] == ref["final_assignment"]
        assert torch.equal(w, pytree.flatten(ref["params"], ttt.REF_LAYOUT))
