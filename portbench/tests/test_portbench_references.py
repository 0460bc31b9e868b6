"""The plain references against ``repro_torch`` at small sizes on the CPU:
the same weights and inputs give the same answers."""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench.harness import traffic  # noqa: E402
from portbench.reference import cnn, coalition, hymba  # noqa: E402

TINY = dict(json.loads((ROOT / "portbench/configs/hymba-1.5b.json")
                       .read_text()),
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
            d_ff=128, vocab=96, dt_rank=4, window=6, dtype="float32")


def _data(n=3, n_local=20, seed=5):
    return traffic.fl_images({"n_clients": n, "n_local": n_local,
                              "n_test": 10, "shards_per_client": 2},
                             seed, "cpu")


def test_cnn_forward_and_layout_match_the_port():
    from repro_torch.core import pytree
    from repro_torch.models import cnn as port

    p = cnn.initial(7, "cpu")
    x = _data()["x"][0]
    torch.testing.assert_close(cnn.forward(p, x), port.apply(p, x),
                               rtol=1e-5, atol=1e-5)
    flat = cnn.flatten(p)
    assert torch.equal(flat, pytree.flatten(p, port.REF_LAYOUT))
    assert all(torch.equal(v, p[k]) for k, v in cnn.unflatten(flat).items())


def test_client_update_matches_the_port():
    from repro_torch.core.client import ClientConfig, client_update
    from repro_torch.models import cnn as port

    p = cnn.initial(8, "cpu")
    d = _data(n=1, n_local=24)      # 2 full batches and a tail of 4
    perms = torch.argsort(torch.rand((2, 24), generator=torch.Generator()
                                     .manual_seed(1)), -1)
    want = cnn.client_update(p, d["x"][0], d["y"][0], perms, 10, 0.05)
    got, _ = client_update(port.loss_fn, p, {"x": d["x"][0], "y": d["y"][0]},
                           perms, ClientConfig(epochs=2, batch_size=10,
                                               lr=0.05))
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6)


def test_algorithm_one_matches_the_port():
    from repro_torch.core import coalitions

    w = torch.randn((12, 50), generator=torch.Generator().manual_seed(2))
    perm = torch.randperm(12, generator=torch.Generator().manual_seed(3))
    state = coalitions.init_centers(w, 3, perm=perm)
    centers = coalition.first_centers(w, perm.tolist(), 3)
    assert state.center_idx.tolist() == centers
    r = coalitions.run_round(w, state, backend="stream")
    d2, allowed = coalition.assign(w, centers)
    assert coalition.bad_choices(d2, r.assignment, allowed) == 0
    want = coalition.aggregate(w, centers, r.assignment)
    assert torch.equal(want["counts"].float(), r.counts)
    torch.testing.assert_close(r.theta.double(), want["theta"], rtol=1e-6,
                               atol=1e-6)
    assert coalition.bad_choices(want["med"].T, r.new_center_idx,
                                 want["member"].T) == 0
    # a centre that is not its coalition's nearest member is a bad choice
    far = want["med"].masked_fill(~want["member"], -1).argmax(0)
    assert coalition.bad_choices(want["med"].T, far, want["member"].T) > 0


def _port_model(cfg):
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    model = tf.init(torch.Generator().manual_seed(0),
                    ModelConfig(**{k: v for k, v in cfg.items()
                                   if k in fields}))
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, value in hymba.initial_leaves(cfg, 4, "cpu",
                                                torch.float32):
            params[name].copy_(value)
    return model, params


def test_hymba_loss_and_gradients_match_the_port():
    from repro_torch.models import transformer as tf

    model, params = _port_model(TINY)
    rows = traffic.lm_rows(3, 9, TINY["vocab"], 4, "cpu")
    ref = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    want = hymba.loss(ref, TINY, rows)
    got = tf.loss_fn(model, {"tokens": rows})
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    g_ref = torch.autograd.grad(want, list(ref.values()))
    g_got = torch.autograd.grad(got, list(params.values()))
    for a, b in zip(g_got, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_hymba_adam_steps_match_the_port():
    from repro_torch.launch import steps
    from repro_torch.models.config import ModelConfig

    model, params = _port_model(TINY)
    start = {k: v.detach().clone() for k, v in params.items()}
    rows = traffic.lm_rows(6, 9, TINY["vocab"], 4, "cpu")
    batches = [rows[:3], rows[3:]]
    want = hymba.train(TINY, start, batches, 1e-2, micro=2)
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    step, opt = steps.make_train_step(
        ModelConfig(**{k: v for k, v in TINY.items() if k in fields}),
        optimizer="adam", lr=1e-2, remat=False)
    state = opt.init(params)
    losses = [float(step(model, state, {"tokens": b})) for b in batches]
    assert abs(losses[0] - want["losses"][0]) < 1e-5
    assert abs(losses[1] - want["losses"][1]) < 1e-4
    for k, v in want["change"].items():
        got = float(torch.linalg.vector_norm(params[k].detach() - start[k]))
        assert abs(got - v) <= 1e-3 * max(v, 1e-3), k
