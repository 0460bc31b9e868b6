"""The port's serving subsystem (``repro_torch.serve``) and ``serve --mode
fl`` against the reference's.

- ``RoutingTable``: known clients to their coalition, strangers (id -1 or
  out of range) to θ, the row convention (0 = θ, 1 + k = coalition k).
- ``ModelStore``: publish/load round trip, retention, schema checks.
- ``BatchServer``: a routed answer equals the direct forward through that
  row's model bit for bit; ``compile_count`` stays flat across ``swap``,
  which writes in place; ``poll`` picks up a newer round; shape changes
  are refused.
- The store both ways: a store the reference's ``ModelStore`` published
  (the paper CNN) is served by the port's ``BatchServer`` and by the
  reference's, their logits within 1e-5 of the max and their routing
  equal; a store the port published is served by the reference's.
- The producer hook on every engine, and the CLI pair: ``train
  --snapshot-dir`` then ``serve --mode fl``, whose JSON has the
  reference's keys plus ``device``; ``--model transformer`` on a reduced
  LM.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pytree as jpt
from repro.launch import serve as jserve
from repro.models import cnn as jcnn
from repro.serve import BatchServer as JBatchServer
from repro.serve import ModelStore as JModelStore
from repro_torch import carry
from repro_torch.core import pytree
from repro_torch.core.server import Federation
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import cnn
from repro_torch.serve import (GLOBAL, SERVE_SCHEMA, BatchServer, ModelStore,
                               RoutingTable, Snapshot)
from repro_torch.testing import cap_cpu_threads
from test_torch_checkpoint import FEAT, N_COAL, N_CLIENTS, fed_setup

cap_cpu_threads()

#: routed logits against the reference's, over their max (both f32)
TOL = 1e-5


def _linear_apply(p, x):
    return x @ p["w"] + p["b"]


LAYOUT = (("b", "b", None), ("w", "w", None))


def _snapshot(seed=0, round_=0, n=N_CLIENTS, classes=4):
    g = torch.Generator().manual_seed(seed)
    gp = {"w": torch.randn((FEAT, classes), generator=g) * 0.1,
          "b": torch.zeros(classes)}
    d = FEAT * classes + classes
    return Snapshot(round=round_, global_params=gp,
                    barycenters=torch.randn((N_COAL, d), generator=g),
                    assignment=np.arange(n) % N_COAL, counts=None, meta={})


def _x(seed=5, b=N_CLIENTS):
    return torch.randn((b, FEAT), generator=torch.Generator().manual_seed(
        seed))


class TestRoutingTable:
    def test_known_unknown_and_rows(self):
        t = RoutingTable([2, 0, 1, 0], n_coalitions=3)
        np.testing.assert_array_equal(t.route([0, 1, 3, 4, -1, 99]),
                                      [2, 0, 0, GLOBAL, GLOBAL, GLOBAL])
        np.testing.assert_array_equal(t.model_rows([0, -1]), [3, 0])

    def test_validation(self):
        with pytest.raises(ValueError, match="only 2 coalitions"):
            RoutingTable([0, 2], n_coalitions=2)
        with pytest.raises(ValueError, match=">= -1"):
            RoutingTable([0, -2])

    def test_from_snapshot_and_eq(self):
        snap = _snapshot()
        t = RoutingTable.from_snapshot(snap)
        assert t.n_coalitions == N_COAL and t.n_clients == N_CLIENTS
        assert t == RoutingTable(np.arange(N_CLIENTS) % N_COAL,
                                 n_coalitions=N_COAL)


class TestModelStore:
    def test_publish_load_roundtrip(self, tmp_path):
        store = ModelStore(str(tmp_path))
        snap = _snapshot()
        store.publish(3, snap.global_params, snap.barycenters,
                      assignment=snap.assignment, counts=[3.0, 3.0],
                      extra_meta={"engine": "scan"})
        got = store.load()
        assert got.round == 3 and got.meta["engine"] == "scan"
        assert got.meta["schema"] == SERVE_SCHEMA == "serve/v1"
        assert torch.equal(got.barycenters, snap.barycenters)
        for k, v in snap.global_params.items():
            assert torch.equal(got.global_params[k], v)
        np.testing.assert_array_equal(got.assignment, snap.assignment)
        np.testing.assert_array_equal(got.counts, [3.0, 3.0])

    def test_retention_prunes_oldest(self, tmp_path):
        store = ModelStore(str(tmp_path), keep=2)
        snap = _snapshot()
        for r in range(5):
            store.publish(r, snap.global_params, snap.barycenters,
                          assignment=snap.assignment)
        assert store.rounds() == [3, 4] and store.latest_round() == 4
        with pytest.raises(ValueError, match="keep"):
            ModelStore(str(tmp_path), keep=0)

    def test_empty_store_and_schema_checks(self, tmp_path):
        store = ModelStore(str(tmp_path))
        assert store.latest_round() is None and store.rounds() == []
        from repro_torch import checkpoint

        checkpoint.save(str(tmp_path), 0, {"a": torch.ones(2)})
        with pytest.raises(ValueError, match="not a serve snapshot"):
            store.load()
        with pytest.raises(ValueError, match="n_coalitions, D"):
            store.publish(1, {"a": torch.ones(2)}, torch.ones(4),
                          assignment=[0])


class TestBatchServer:
    def test_routed_matches_direct_bitexact(self):
        snap = _snapshot()
        server = BatchServer(_linear_apply, LAYOUT, snap)
        ids = np.array([0, 1, 2, 3, -1, 5])
        x = _x()
        out = server.serve(ids, x)
        rows = RoutingTable.from_snapshot(snap).model_rows(ids)
        for q, row in enumerate(rows):
            direct = _linear_apply(server.model_params(int(row)), x)[q]
            assert torch.equal(out[q], direct)
        theta = pytree.flatten(server.model_params(0), LAYOUT)
        assert torch.equal(theta, pytree.flatten(snap.global_params, LAYOUT))
        assert torch.equal(pytree.flatten(server.model_params(2), LAYOUT),
                           snap.barycenters[1])

    def test_swap_is_in_place_and_never_rebuilds(self):
        server = BatchServer(_linear_apply, LAYOUT, _snapshot(0))
        ids, x = np.arange(N_CLIENTS), _x()
        server.serve(ids, x)
        n0 = server.compile_count
        before = {k: v.data_ptr() for k, v in server._stacked.items()}
        for r in (1, 2, 3):
            snap = _snapshot(r, round_=r)
            server.swap(snap)
            out = server.serve(ids, x)
            for q in range(N_CLIENTS):
                k = int(snap.assignment[q])
                direct = _linear_apply(pytree.unflatten(
                    snap.barycenters[k], LAYOUT, snap.global_params), x)[q]
                assert torch.equal(out[q], direct)
        assert server.compile_count == n0 == 1
        assert {k: v.data_ptr() for k, v in server._stacked.items()} \
            == before
        assert server.round == 3 and server.stats["compiles"] == 1

    def test_swap_rejects_shape_change(self):
        server = BatchServer(_linear_apply, LAYOUT, _snapshot())
        with pytest.raises(ValueError, match="hot-swappable"):
            server.swap(_snapshot(classes=5))
        with pytest.raises(ValueError, match="hot-swappable"):
            server.swap(_snapshot(n=N_CLIENTS + 1))
        assert server.round == 0

    def test_serve_requires_snapshot_and_matching_ids(self):
        server = BatchServer(_linear_apply, LAYOUT)
        with pytest.raises(RuntimeError, match="no snapshot"):
            server.serve([0], _x(b=1))
        with pytest.raises(RuntimeError, match="nothing installed"):
            server.swap(_snapshot())
        server.install(_snapshot())
        with pytest.raises(ValueError, match="client ids"):
            server.serve([0, 1], _x(b=3))

    def test_poll_picks_up_newer_rounds(self, tmp_path):
        store = ModelStore(str(tmp_path))
        server = BatchServer(_linear_apply, LAYOUT)
        assert not server.poll(store)                 # empty store
        for r in (0, 1):
            s = _snapshot(r)
            store.publish(r, s.global_params, s.barycenters,
                          assignment=s.assignment)
            assert server.poll(store) and server.round == r
            server.serve(np.arange(N_CLIENTS), _x())
        assert not server.poll(store)                 # nothing newer
        s = server.stats
        assert (s["polls"], s["poll_hits"], s["swaps"], s["compiles"]) \
            == (4, 2, 2, 1)
        assert s["swap_ms_total"] > 0


def _reference_cnn_store(root, rounds=(0, 1), n=6, k=3):
    """A store the reference's ModelStore published: the paper CNN's θ and
    K barycenters (θ plus seeded noise) per round."""
    store = JModelStore(root)
    for r in rounds:
        gp = jcnn.init(jax.random.key(r))
        theta = jpt.flatten(gp)
        bary = theta[None] + 0.05 * jax.random.normal(
            jax.random.key(100 + r), (k, theta.shape[0]))
        store.publish(r, gp, bary, assignment=(np.arange(n) + r) % k,
                      counts=np.full(k, n / k))
    return store


def test_port_serves_a_reference_store(tmp_path):
    jstore = _reference_cnn_store(str(tmp_path))
    store = ModelStore(str(tmp_path))
    assert store.rounds() == jstore.rounds() == [0, 1]
    server = BatchServer(cnn.apply, cnn.REF_LAYOUT, store.load(0))
    jserver = JBatchServer(jcnn.apply, jstore.load(0))
    ids = np.array([0, 1, 2, 3, 4, 5, -1, 17])
    x = np.random.default_rng(3).random((8, 28, 28, 1), dtype=np.float32)
    for r in (0, 1):
        if r:
            assert server.poll(store) and jserver.poll(jstore)
        got = server.serve(ids, torch.from_numpy(x)).numpy()
        want = np.asarray(jserver.serve(ids, jnp.asarray(x)))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=TOL)
        np.testing.assert_array_equal(server.routing.route(ids),
                                      jserver.routing.route(ids))
        assert list(server.routing.route(ids)[-2:]) == [GLOBAL, GLOBAL]
        # strangers get θ
        theta_out = cnn.apply(server.model_params(0), torch.from_numpy(x))
        assert torch.equal(torch.from_numpy(got[-2:]), theta_out[-2:])
    assert server.compile_count == 1 and server.round == 1


def test_reference_serves_a_port_store(tmp_path):
    cfg, params, data, eval_fn, model = fed_setup(rounds=3)
    store = ModelStore(str(tmp_path))
    gp, _ = Federation(model, eval_fn, cfg).run(
        params, data, generator=torch.Generator().manual_seed(0),
        snapshot_every=1, store=store)
    jstore = JModelStore(str(tmp_path))
    assert jstore.rounds() == [0, 1, 2]
    jsnap = jstore.load()
    np.testing.assert_array_equal(np.asarray(jsnap.global_params["w"]),
                                  gp["w"].numpy())
    jserver = JBatchServer(lambda p, x: x @ p["w"] + p["b"], jsnap)
    server = BatchServer(_linear_apply, LAYOUT, store.load())
    ids, x = np.array([0, 3, 5, -1]), _x(b=4)
    want = np.asarray(jserver.serve(ids, jnp.asarray(x.numpy())))
    got = server.serve(ids, x).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    assert jsnap.meta["engine"] == "scan" and jsnap.meta["n_clients"] == 6


@pytest.mark.parametrize("engine", ["scan", "python", "semi_async",
                                    "event_driven"])
def test_publisher_hook_all_engines(tmp_path, engine):
    cfg, params, data, eval_fn, model = fed_setup(engine=engine)
    store = ModelStore(str(tmp_path))
    gp, hist = Federation(model, eval_fn, cfg).run(
        params, data, generator=torch.Generator().manual_seed(0),
        snapshot_every=2, store=store)
    assert store.rounds() == [0, 2, 4, 5]     # cadence + the final round
    snap = store.load()
    assert snap.meta["engine"] == engine
    for k in gp:
        assert torch.equal(gp[k], snap.global_params[k])
    assert snap.barycenters.shape == (N_COAL,
                                      pytree.flatten(gp, LAYOUT).shape[0])
    np.testing.assert_array_equal(snap.assignment, hist.assignments[-1])


def test_flat_rule_broadcasts_global(tmp_path):
    cfg, params, data, eval_fn, model = fed_setup(rounds=3, method="fedavg")
    store = ModelStore(str(tmp_path))
    gp, _ = Federation(model, eval_fn, cfg).run(
        params, data, generator=torch.Generator().manual_seed(0),
        snapshot_every=1, store=store)
    theta = pytree.flatten(gp, LAYOUT)
    for row in store.load().barycenters:
        assert torch.equal(row, theta)


def test_cli_train_then_serve(tmp_path, capsys):
    store_dir = str(tmp_path / "store")
    ttrain.main(["--mode", "fl", "--device", "cpu", "--rounds", "2",
                 "--clients", "4", "--coalitions", "2", "--local-epochs",
                 "1", "--n-train", "200", "--n-test", "50",
                 "--snapshot-dir", store_dir, "--snapshot-keep", "1"])
    capsys.readouterr()
    argv = ["--mode", "fl", "--store-dir", store_dir, "--batch", "8",
            "--repeat", "3", "--metrics-out", str(tmp_path / "s.jsonl")]
    got = tserve.main(argv + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    want = jserve.run_fl_serve(jserve.build_parser().parse_args(argv))
    capsys.readouterr()
    assert set(printed) == set(want) | {"device"} and printed == got
    for key in ("round", "published_rounds", "n_coalitions",
                "global_fallback_queries", "hot_swaps", "fallback_rate"):
        assert got[key] == want[key], key
    assert got["published_rounds"] == [1] and got["compile_count"] == 1
    records = [json.loads(ln) for ln in open(tmp_path / "s.jsonl")]
    assert [r["kind"] for r in records] == ["serve_batch"] * 3
    with pytest.raises(SystemExit, match="--store-dir"):
        tserve.main(["--mode", "fl", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no snapshots"):
        tserve.main(["--mode", "fl", "--device", "cpu", "--store-dir",
                     str(tmp_path / "empty")])


def test_transformer_model_serves_routed_rows(tmp_path):
    """``--model transformer``: a reduced LM's θ and barycenters, published
    by reference leaf names (layers stacked), served per coalition."""
    from repro_torch.configs import get, reduced
    from repro_torch.models import transformer as tf

    cfg = reduced(get("falcon-mamba-7b"))
    model = tf.init(torch.Generator().manual_seed(0), cfg)
    layout = carry.transformer_layout(model)
    params = {k: v.detach() for k, v in model.named_parameters()}
    theta = pytree.flatten(params, layout)
    bary = theta[None] + 0.01 * torch.randn(
        (2, theta.shape[0]), generator=torch.Generator().manual_seed(1))
    ModelStore(str(tmp_path)).publish(
        0, pytree.to_ref_tree(params, layout), bary,
        assignment=[0, 1, 1])
    out = tserve.main(["--mode", "fl", "--device", "cpu", "--store-dir",
                       str(tmp_path), "--model", "transformer", "--batch",
                       "4", "--repeat", "1"])
    assert out["n_coalitions"] == 2 and out["global_fallback_queries"] == 1
    apply_fn, make_queries, lay = tserve.make_apply_fn(
        "transformer", "falcon-mamba-7b", True, torch.device("cpu"))
    assert lay == layout
    server = BatchServer(apply_fn, lay, ModelStore(str(tmp_path)).load())
    toks = make_queries(4, 0)
    got = server.serve([0, 1, 2, -1], toks)
    for q, row in enumerate((1, 2, 2, 0)):
        direct = apply_fn(pytree.unflatten(
            theta if row == 0 else bary[row - 1], layout, params), toks)
        assert torch.equal(got[q], direct[q])
