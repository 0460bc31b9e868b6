"""The port's small public surface against the reference's: learning-rate
schedules, ``clip_by_global_norm``, ``chain``, a callable ``lr``,
``ClientConfig.momentum``, ``synthetic.digits_split``, ``loader.batches``,
``partition.REGIMES``, ``distance.dists_to_points`` and
``server.run_federation``.  The cases follow tests/test_substrate.py's
optimizer tests; f32 values agree within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as jclient
from repro.core import distance as jdist
from repro.data import loader as jloader
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.core import client as tclient
from repro_torch.core import distance as tdist
from repro_torch.core import server as tserver
from repro_torch.data import loader as tloader
from repro_torch.data import partition as tpartition
from repro_torch.data import synthetic as tsynthetic
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

SCHEDULES = [("constant", (0.3,)), ("linear_warmup", (1.0, 10)),
             ("cosine_decay", (2.0, 10)), ("cosine_decay", (2.0, 10, 0.1)),
             ("warmup_cosine", (1.0, 10, 100)),
             ("warmup_cosine", (0.5, 5, 50, 0.2))]


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedules_match_reference(name, args):
    ref = getattr(jsched, name)(*args)
    got = getattr(tsched, name)(*args)
    for step in (0, 1, 5, 10, 11, 50, 100, 150):
        np.testing.assert_allclose(float(got(torch.tensor(step))),
                                   float(ref(jnp.int32(step))), rtol=1e-6,
                                   atol=1e-7)
        assert float(got(step)) == float(got(torch.tensor(step)))


def test_warmup_cosine_endpoints():
    s = tsched.warmup_cosine(1.0, 10, 100)
    assert float(s(0)) == 0.0
    np.testing.assert_allclose(float(s(10)), 1.0, rtol=1e-5)
    assert float(s(100)) < 1e-3
    assert float(tsched.cosine_decay(2.0, 10)(0)) == 2.0


def test_clip_by_global_norm_matches_reference():
    g = {"a": np.array([3.0, 4.0], np.float32),
         "b": np.array([[1.0], [-2.0]], np.float32)}
    for max_norm in (1.0, 100.0):
        ref = jopt.clip_by_global_norm(max_norm)(
            {k: jnp.asarray(v) for k, v in g.items()})
        got = topt.clip_by_global_norm(max_norm)(
            {k: torch.from_numpy(v) for k, v in g.items()})
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-6)
    c = topt.clip_by_global_norm(1.0)({"a": torch.tensor([3.0, 4.0])})
    np.testing.assert_allclose(float(torch.linalg.norm(c["a"])), 1.0,
                               rtol=1e-5)


def test_chain_clipped_sgd():
    opt = topt.chain(topt.clip_by_global_norm(0.5), topt.sgd(1.0))
    params = {"x": torch.tensor([10.0])}
    state = opt.init(params)
    upd, _ = opt.update({"x": torch.tensor([100.0])}, state, params)
    np.testing.assert_allclose(upd["x"].numpy(), [-0.5], rtol=1e-5)
    opt.step(params, {"x": torch.tensor([100.0])}, state)    # in place
    np.testing.assert_allclose(params["x"].numpy(), [9.5], rtol=1e-6)


@pytest.mark.parametrize("which", ["sgd", "sgd_momentum", "adam"])
def test_callable_lr_matches_reference(which):
    """A schedule as ``lr``: the same updates as the reference's over five
    steps on a quadratic (sgd reads it before its step count advances,
    adam after, as the reference does)."""
    sched = (jsched.warmup_cosine(0.1, 2, 5), tsched.warmup_cosine(0.1, 2, 5))
    make = {"sgd": lambda m, s: m.sgd(s),
            "sgd_momentum": lambda m, s: m.sgd(s, momentum=0.9),
            "adam": lambda m, s: m.adam(s)}[which]
    jo, to = make(jopt, sched[0]), make(topt, sched[1])
    jp = {"x": jnp.array([3.0, -2.0])}
    tp = {"x": torch.tensor([3.0, -2.0])}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(5):
        jg = jax.grad(lambda p: jnp.sum(p["x"] ** 2))(jp)
        ju, js = jo.update(jg, js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update({"x": 2 * tp["x"]}, ts, tp)
        tp = topt.apply_updates(tp, tu)
        np.testing.assert_allclose(tp["x"].numpy(), np.asarray(jp["x"]),
                                   rtol=1e-5)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_client_momentum_matches_reference(momentum):
    """``ClientConfig.momentum``: one client's local update of softmax
    regression equals the reference's on the same batch order."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 6)).astype(np.float32)
    y = rng.integers(0, 3, 12).astype(np.int32)
    w0 = 0.1 * rng.standard_normal((6, 3)).astype(np.float32)

    def jloss(p, batch):
        logp = jax.nn.log_softmax(batch["x"] @ p["w"])
        return -jnp.mean(jnp.take_along_axis(logp, batch["y"][:, None], 1))

    def tloss(p, batch):
        logp = torch.log_softmax(batch["x"] @ p["w"], dim=-1)
        return -torch.mean(torch.gather(logp, 1, batch["y"].long()[:, None]))

    key = jax.random.key(3)
    ref, _ = jclient.client_update(
        jloss, {"w": jnp.asarray(w0)}, {"x": jnp.asarray(x),
                                        "y": jnp.asarray(y)}, key,
        jclient.ClientConfig(epochs=2, batch_size=4, lr=0.1,
                             momentum=momentum))
    perms = torch.from_numpy(np.stack([
        np.asarray(jax.random.permutation(ek, 12))
        for ek in jax.random.split(key, 2)]))
    got, _ = tclient.client_update(
        tloss, {"w": torch.from_numpy(w0)}, {"x": torch.from_numpy(x),
                                             "y": torch.from_numpy(y)},
        perms, tclient.ClientConfig(epochs=2, batch_size=4, lr=0.1,
                                    momentum=momentum))
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(ref["w"]),
                               rtol=1e-5, atol=1e-6)
    assert tclient.ClientConfig._fields == jclient.ClientConfig._fields


def test_digits_split_and_batches_match_reference():
    (jxtr, jytr), (jxte, jyte) = jsynthetic.digits_split(50, 20, seed=3)
    (txtr, tytr), (txte, tyte) = tsynthetic.digits_split(50, 20, seed=3)
    for a, b in ((jxtr, txtr), (jytr, tytr), (jxte, txte), (jyte, tyte)):
        np.testing.assert_array_equal(a, b)
    for drop in (True, False):
        ref = list(jloader.batches(jxtr, jytr, 16, seed=2,
                                   drop_remainder=drop))
        got = list(tloader.batches(txtr, tytr, 16, seed=2,
                                   drop_remainder=drop))
        assert len(got) == len(ref) == (3 if drop else 4)
        for (gx, gy), (rx, ry) in zip(got, ref):
            np.testing.assert_array_equal(gx, rx)
            np.testing.assert_array_equal(gy, ry)


def test_regimes_alias():
    assert tpartition.REGIMES is tpartition._PARTITIONERS
    assert set(tpartition.REGIMES) == set(jpartition.REGIMES)


def test_dists_to_points_matches_reference():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((7, 300)).astype(np.float32)
    p = rng.standard_normal((3, 300)).astype(np.float32)
    ref = np.asarray(jdist.dists_to_points(jnp.asarray(w), jnp.asarray(p)))
    got = tdist.dists_to_points(torch.from_numpy(w), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_run_federation_equals_federation_run():
    from test_torch_checkpoint import fed_setup

    cfg, params, data, eval_fn, model = fed_setup(rounds=3)
    _, want = tserver.Federation(model, eval_fn, cfg).run(
        params, data, generator=torch.Generator().manual_seed(5))
    got = tserver.run_federation(params, model, eval_fn, data, cfg,
                                 generator=torch.Generator().manual_seed(5))
    assert got.assignments == want.assignments
    np.testing.assert_array_equal(got.trace.loss, want.trace.loss)
