"""The port's checkpoint layer and federation resume.

- ``save`` / ``restore`` / ``load`` round-trip f32, bf16 and int32 leaves
  exactly; strictness (missing, renamed, reshaped leaves raise), discovery
  (malformed entries skipped), atomic re-save, the ``federation/v2``
  schema.
- The format both ways: the reference's ``checkpoint.load`` reads a
  port-written step with the same names, dtypes and values, and the port's
  reads a reference-written one.
- Resume: a run checkpointed every round, cut back to round 2 and resumed
  to round 3, returns the uninterrupted 3-round run's θ and ``History``
  bit for bit on the CPU, on ``scan``, ``semi_async``, ``event_driven``
  and cohort mode; an empty directory is a fresh start; another engine's
  checkpoint raises; the train CLI's ``--resume``.

The federation runs use softmax regression on 8 features (the reference's
tests/test_serve.py setup), so each takes well under a second.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro_torch import checkpoint
from repro_torch import sim as tsim
from repro_torch.core.client import ClientConfig
from repro_torch.core.server import (TIMING_FIELDS, Federation,
                                     FederationConfig)
from repro_torch.launch import train as ttrain
from repro_torch.models import zoo
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

N_CLIENTS, N_COAL, FEAT, CLASSES = 6, 2, 8, 4


def _loss(p, batch):
    logp = torch.log_softmax(batch["x"] @ p["w"] + p["b"], dim=-1)
    return -torch.mean(torch.gather(logp, 1, batch["y"].long()[:, None]))


def _acc(p, x, y):
    return torch.mean((torch.argmax(x @ p["w"] + p["b"], -1) == y).float())


LINEAR = zoo.FLModel(name="linear8", init=None, loss_fn=_loss,
                     accuracy=_acc,
                     layout=(("b", "b", None), ("w", "w", None)))


def fed_setup(rounds: int = 6, **cfg_kw):
    """(config, θ^(0), client data, eval_fn, model) of a 6-client,
    2-coalition softmax regression, its data from a numpy seed."""
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.standard_normal((N_CLIENTS, 8, FEAT))
                          .astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, CLASSES, (N_CLIENTS, 8)))
    params = {"w": torch.from_numpy(
        0.1 * rng.standard_normal((FEAT, CLASSES)).astype(np.float32)),
        "b": torch.zeros(CLASSES)}
    cfg_kw.setdefault("method", "coalition")
    cfg = FederationConfig(n_clients=N_CLIENTS, n_coalitions=N_COAL,
                           rounds=rounds,
                           client=ClientConfig(epochs=1, batch_size=4),
                           **cfg_kw)
    return (cfg, params, {"x": xs, "y": ys},
            lambda p: _acc(p, xs[0], ys[0]), LINEAR)


def _tree(seed: int = 0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {"layer": {"w": torch.randn((4, 3), generator=g).to(dtype),
                      "b": torch.zeros((3,), dtype=dtype)},
            "head": torch.randn((3, 2), generator=g).to(dtype),
            "ids": torch.arange(5, dtype=torch.int32)}


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


class TestRoundTrip:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_restore_is_exact(self, tmp_path, dtype):
        tree = _tree(0, dtype)
        checkpoint.save(str(tmp_path), 3, tree)
        like = {"layer": {k: torch.zeros_like(v)
                          for k, v in tree["layer"].items()},
                "head": torch.zeros_like(tree["head"]),
                "ids": torch.zeros_like(tree["ids"])}
        assert _same(tree, checkpoint.restore(str(tmp_path), like))

    def test_load_is_template_free(self, tmp_path):
        tree = _tree(1, torch.bfloat16)
        checkpoint.save(str(tmp_path), 0, tree, extra_meta={"tag": "x"})
        loaded, meta = checkpoint.load(str(tmp_path))
        assert meta["tag"] == "x" and meta["step"] == 0
        assert meta["dtypes"]["layer/w"] == "bfloat16"
        assert meta["dtypes"]["ids"] == "int32"
        assert loaded["layer"]["w"].dtype == torch.bfloat16   # cast back
        assert _same(tree, loaded)

    def test_save_creates_dir(self, tmp_path):
        d = str(tmp_path / "a" / "b")
        checkpoint.save(d, 0, _tree())
        assert checkpoint.latest_step(d) == 0


class TestStrictness:
    def test_extra_and_renamed_leaves_raise(self, tmp_path):
        tree = _tree()
        checkpoint.save(str(tmp_path), 0, tree)
        renamed = dict(tree, layer={"weight": tree["layer"]["w"],
                                    "b": tree["layer"]["b"]})
        with pytest.raises(KeyError, match="layer/w"):
            checkpoint.restore(str(tmp_path), renamed)
        with pytest.raises(KeyError, match="extra"):
            checkpoint.restore(str(tmp_path), dict(tree, more=tree["head"]))

    def test_shape_mismatch_raises(self, tmp_path):
        tree = _tree()
        checkpoint.save(str(tmp_path), 0, tree)
        with pytest.raises(ValueError, match="shape"):
            checkpoint.restore(str(tmp_path),
                               dict(tree, head=torch.zeros((2, 3))))


class TestDiscovery:
    def test_latest_skips_malformed(self, tmp_path):
        checkpoint.save(str(tmp_path), 2, _tree())
        os.makedirs(tmp_path / "step_foo")
        os.makedirs(tmp_path / ".tmp-step-abc")
        (tmp_path / "step_00000009").write_text("not a dir")
        assert checkpoint.available_steps(str(tmp_path)) == [2]
        assert checkpoint.latest_step(str(tmp_path)) == 2

    def test_empty_and_missing_dirs(self, tmp_path):
        assert checkpoint.available_steps(str(tmp_path / "nope")) == []
        assert checkpoint.latest_step(str(tmp_path)) is None
        with pytest.raises(FileNotFoundError):
            checkpoint.load(str(tmp_path))

    def test_resave_same_step_replaces(self, tmp_path):
        checkpoint.save(str(tmp_path), 0, _tree(0))
        checkpoint.save(str(tmp_path), 0, _tree(9))
        out, _ = checkpoint.load(str(tmp_path), 0)
        assert _same(_tree(9), out)
        assert os.listdir(tmp_path) == ["step_00000000"]


class TestFederationSchema:
    def test_schema_contents(self, tmp_path):
        state = (torch.arange(3), {"centers": torch.ones((2, 5))})
        trace = {"loss": np.ones(4, np.float32), "acc": np.zeros(4)}
        carry = {"bary": torch.ones((2, 5)),
                 "rng": {"run": torch.Generator().get_state()}}
        checkpoint.save_federation(str(tmp_path), 7, _tree(), state,
                                   carry=carry, trace=trace,
                                   extra_meta={"engine": "scan"})
        tree, meta = checkpoint.load(str(tmp_path))
        assert meta["schema"] == checkpoint.FEDERATION_SCHEMA \
            == jck.FEDERATION_SCHEMA == "federation/v2"
        assert meta["engine"] == "scan" and int(tree["round"]) == 7
        assert _same(_tree(), tree["global"])
        assert sorted(tree["strategy"]) == ["0000", "0001"]
        assert set(tree["carry"]) == {"bary", "rng"}
        assert tree["carry"]["rng"]["run"].dtype == torch.uint8
        assert set(tree["trace"]) == {"loss", "acc"}

    def test_any_strategy_state(self, tmp_path):
        checkpoint.save_federation(str(tmp_path), 0, _tree(), 12)
        tree, _ = checkpoint.load(str(tmp_path))
        assert int(tree["strategy"]["0000"]) == 12


class TestInterop:
    """The on-disk format both ways: names, dtypes and values."""

    def test_reference_reads_port_step(self, tmp_path):
        tree = {**_tree(2), "low": _tree(3, torch.bfloat16)}
        checkpoint.save(str(tmp_path), 4, tree)
        loaded, meta = jck.load(str(tmp_path))
        assert meta["step"] == 4
        flat = jax.tree_util.tree_flatten_with_path(loaded)[0]
        names = ["/".join(str(getattr(k, "key", k)) for k in path)
                 for path, _ in flat]
        want = [n for n, _ in checkpoint.checkpoint._walk(tree)]
        assert names == want
        for name, leaf in checkpoint.checkpoint._walk(tree):
            got = loaded
            for part in name.split("/"):
                got = got[part]
            assert str(got.dtype) == str(leaf.dtype).removeprefix("torch.")
            np.testing.assert_array_equal(
                np.asarray(got.astype(jnp.float32)), leaf.float().numpy())

    def test_port_reads_reference_step(self, tmp_path):
        k1, k2 = jax.random.split(jax.random.key(5))
        tree = {"layer": {"w": jax.random.normal(k1, (4, 3)).astype(
            jnp.bfloat16), "b": jnp.zeros((3,))},
            "head": jax.random.normal(k2, (3, 2)),
            "ids": jnp.arange(5, dtype=jnp.int32)}
        jck.save(str(tmp_path), 1, tree)
        loaded, meta = checkpoint.load(str(tmp_path))
        assert meta["step"] == 1
        assert loaded["layer"]["w"].dtype == torch.bfloat16
        assert loaded["ids"].dtype == torch.int32
        np.testing.assert_array_equal(
            loaded["layer"]["w"].float().numpy(),
            np.asarray(tree["layer"]["w"].astype(jnp.float32)))
        np.testing.assert_array_equal(loaded["head"].numpy(),
                                      np.asarray(tree["head"]))
        like = {"layer": {"w": torch.zeros((4, 3), dtype=torch.bfloat16),
                          "b": torch.zeros(3)},
                "head": torch.zeros((3, 2)),
                "ids": torch.zeros(5, dtype=torch.int32)}
        assert _same(loaded, checkpoint.restore(str(tmp_path), like))


# -- resume -------------------------------------------------------------------

ENGINES = {"scan": {}, "semi_async": {"engine": "semi_async"},
           "event_driven": {"engine": "event_driven"},
           "cohort": {"fleet_size": 64}}
FLEET = {"scan": "ideal", "semi_async": "cellular-flaky",
         "event_driven": "cellular-flaky", "cohort": "cellular-flaky"}


def _run(name, rounds=3, **run_kw):
    cfg, params, data, eval_fn, model = fed_setup(
        rounds=rounds, sim=tsim.SimConfig(fleet=FLEET[name]), **ENGINES[name])
    return Federation(model, eval_fn, cfg).run(
        params, data, generator=torch.Generator().manual_seed(7), **run_kw)


def _assert_same_run(a, b):
    (gp_a, h_a), (gp_b, h_b) = a, b
    for k in gp_a:
        assert torch.equal(gp_a[k], gp_b[k]), k
    for f in h_a.trace._fields:
        x, y = getattr(h_a.trace, f), getattr(h_b.trace, f)
        assert (x is None) == (y is None), f
        if x is not None and f not in TIMING_FIELDS:
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("name", list(ENGINES))
def test_resume_is_bitexact(tmp_path, name):
    """Checkpoint every round, drop the last, resume: the uninterrupted
    run's θ and History bit for bit (host timings aside)."""
    full = _run(name)
    d = str(tmp_path / name)
    _run(name, ckpt_every=1, ckpt_dir=d)
    assert checkpoint.available_steps(d) == [0, 1, 2]
    shutil.rmtree(os.path.join(d, "step_00000002"))       # the "kill"
    resumed = _run(name, ckpt_dir=d, resume=True)
    _assert_same_run(full, resumed)
    if name in ("semi_async", "event_driven"):
        assert not np.asarray(full[1].participation).all()


def test_resume_mid_run_on_a_longer_cadence(tmp_path):
    """Checkpoints at rounds 0, 2, 4, 5 of 6; resumed from round 2."""
    full = _run("scan", rounds=6)
    d = str(tmp_path)
    _run("scan", rounds=6, ckpt_every=2, ckpt_dir=d)
    assert checkpoint.available_steps(d) == [0, 2, 4, 5]
    for s in (4, 5):
        shutil.rmtree(os.path.join(d, f"step_{s:08d}"))
    _assert_same_run(full, _run("scan", rounds=6, ckpt_dir=d, resume=True))


def test_resume_empty_dir_is_fresh_start(tmp_path):
    _assert_same_run(_run("scan"),
                     _run("scan", ckpt_dir=str(tmp_path / "new"),
                          resume=True))


def test_resume_wrong_engine_raises(tmp_path):
    d = str(tmp_path)
    _run("scan", ckpt_every=2, ckpt_dir=d)
    with pytest.raises(ValueError, match="engine"):
        _run("semi_async", ckpt_dir=d, resume=True)


def test_hook_validation():
    cfg, params, data, eval_fn, model = fed_setup()
    fed = Federation(model, eval_fn, cfg)
    gen = torch.Generator().manual_seed(0)
    for kw, match in (({"snapshot_every": 2}, "store"),
                      ({"store": object()}, "snapshot_every"),
                      ({"ckpt_every": 2}, "ckpt_dir"),
                      ({"resume": True}, "ckpt_dir"),
                      ({"ckpt_dir": "/nonexistent"}, "ckpt_every or resume"),
                      ({"metrics_every": 2}, "sink"),
                      ({"metrics_every": 0, "sink": object()}, ">= 1")):
        with pytest.raises(ValueError, match=match):
            fed.run(params, data, generator=gen, **kw)


def test_cli_resume(tmp_path, capsys):
    """``train --ckpt-dir --ckpt-every 1``, the last step dropped, then
    ``--resume``: the same summary, ``ckpt_rounds`` and ``resumed``."""
    args = ["--mode", "fl", "--device", "cpu", "--rounds", "3", "--clients",
            "4", "--coalitions", "2", "--local-epochs", "1", "--n-train",
            "200", "--n-test", "50", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "1"]
    full = ttrain.main(args + ["--out", str(tmp_path / "a.json")])
    shutil.rmtree(tmp_path / "step_00000002")
    resumed = ttrain.main(args + ["--resume"])
    capsys.readouterr()
    for key in ("test_acc", "train_loss", "final_assignment", "mean_drift"):
        assert resumed[key] == full[key], key
    assert resumed["ckpt_rounds"] == [0, 1, 2] and resumed["resumed"]
    written = json.loads((tmp_path / "a.json").read_text())
    assert written["ckpt_rounds"] == [0, 1, 2] and not written["resumed"]
