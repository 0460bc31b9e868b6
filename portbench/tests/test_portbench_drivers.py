"""Each driver's set-up, window, traced window and comparison at a tiny
size on the CPU (the drivers called from the test: ``run.py`` refuses a
machine without a card), and the comparison catching each fault a cell
can have, planted in the program underneath the timed path."""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench.harness import spec  # noqa: E402

CPU = torch.device("cpu")
FL_SIZES = {"n_clients": 6, "n_local": 20, "n_test": 60, "batch_size": 10,
            "epochs": 2, "check_clients": 3}
LM_SIZES = {"batch": 4, "seq": 16, "micro": 2, "pool_steps": 8,
            "trace_steps": 1}


#: limits for the pretrain driver at the tiny f32 width, where the program
#: and the reference agree to round-off (the cell's own have none yet)
LM_F32_LIMITS = {"loss_gap": 1e-3, "grad_norm_gap": 1e-3,
                 "change_norm_gap": 1e-2, "unmoved_leaves": 0}


def _lm_cell():
    """The pretrain cell (not in BENCHMARK.json yet: its workload file
    keeps its entries) at a tiny width, in f32."""
    name = "pretrain_hymba_s128"
    cell = spec.cell(name, spec.with_pending(name))
    tiny = dict(cell.config, n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_head=16, d_ff=128, vocab=256, dt_rank=4,
                dtype="float32")
    return dataclasses.replace(cell, config=tiny,
                               workload=dict(cell.workload,
                                             limits=LM_F32_LIMITS))


def _run(cell, sizes, trace=False, seed=2 ** 35 + 3):
    driver = spec.load_module("drivers", cell.driver)
    out = driver.run(cell, seed=seed, seconds=0.5, trace=trace, device=CPU,
                     t_start=time.perf_counter(), sizes=sizes)
    return out, out.verify()


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_fl_runs_and_is_correct():
    cell = spec.cell("fl_cnn_cohort100")
    out, checks = _run(cell, FL_SIZES, trace=True)
    assert checks.correct, checks.lines()
    assert out.attempted >= 3 and out.failed == 0
    assert set(out.end_to_end) == {"fl_samples_per_s", "peak_mem_gib",
                                   "setup_s"}
    assert out.end_to_end["fl_samples_per_s"] > 0
    assert {n for n, _, _ in checks.items} == set(cell.workload["limits"])
    assert any("sampled clients' gaps" in n
               for n in checks.notes)
    values = {m["name"]: spec.load_module("metrics", m["name"]).read(out.ctx)
              for m in cell.per_layer}
    assert values["local_phase_ms.fl"] > 0 and values["server_step_ms.fl"] > 0
    assert values["step_mfu.fl"] > 0
    # no device here: the kernel reader finds nothing to read
    assert values["kernel_roofline.fl"] is None


def test_pretrain_runs_and_is_correct():
    cell = _lm_cell()
    out, checks = _run(cell, LM_SIZES, trace=True)
    assert checks.correct, checks.lines()
    assert out.attempted >= 1 and out.failed == 0
    assert set(out.end_to_end) == {"train_tokens_per_s", "peak_mem_gib",
                                   "setup_s"}
    values = {m["name"]: spec.load_module("metrics", m["name"]).read(out.ctx)
              for m in cell.per_layer}
    assert values["scan_host_ms.pretrain"] > 0
    assert values["step_mfu.pretrain"] > 0
    assert values["kernel_roofline.pretrain"] is None


# --- faults planted in the program ------------------------------------------

def _unchanged_local_phase(loss_fn, gp, client_data, perms, cfg):
    n = next(iter(client_data.values())).shape[0]
    return ({k: v[None].expand(n, *v.shape).clone() for k, v in gp.items()},
            torch.zeros(n))


def _half_batch_fl(monkeypatch):
    from repro_torch.models import zoo

    model = zoo.make_model("cnn")

    def loss(p, batch):
        half = {k: v[:max(1, v.shape[0] // 2)] for k, v in batch.items()}
        return model.loss_fn(p, half)

    monkeypatch.setitem(zoo._REGISTRY, "cnn", model._replace(loss_fn=loss))


def _altered_theta(monkeypatch):
    from repro_torch.core import coalitions

    real = coalitions.run_round

    def run_round(*a, **k):
        r = real(*a, **k)
        return r._replace(theta=r.theta + 1e-3)

    monkeypatch.setattr(coalitions, "run_round", run_round)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_fl_comparison_catches(fault, monkeypatch):
    if fault == "state_unchanged":
        from repro_torch.core import server

        monkeypatch.setattr(server, "local_phase", _unchanged_local_phase)
    elif fault == "half_batch":
        _half_batch_fl(monkeypatch)
    else:
        _altered_theta(monkeypatch)
    _, checks = _run(spec.cell("fl_cnn_cohort100"), FL_SIZES)
    assert not checks.correct, checks.lines()


def _frozen_adam(monkeypatch):
    from repro_torch.optim import optimizers

    real = optimizers.adam

    def adam(lr, **kw):
        opt = real(lr, **kw)
        return opt._replace(step=lambda params, grads, state: None)

    monkeypatch.setattr(optimizers, "adam", adam)


def _half_batch_lm(monkeypatch):
    from repro_torch.models import transformer

    real = transformer.loss_fn

    def loss_fn(model, batch, **kw):
        rows = batch["tokens"]
        return real(model, {"tokens": rows[:rows.shape[0] // 2]}, **kw)

    monkeypatch.setattr(transformer, "loss_fn", loss_fn)


def _altered_token(monkeypatch):
    from repro_torch.models import transformer

    real = transformer.Transformer.embed_inputs

    def embed_inputs(self, batch):
        toks = batch["tokens"].clone()
        toks[:, 1] = (toks[:, 1] + 1) % self.cfg.vocab
        return real(self, {**batch, "tokens": toks})

    monkeypatch.setattr(transformer.Transformer, "embed_inputs",
                        embed_inputs)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_pretrain_comparison_catches(fault, monkeypatch):
    {"state_unchanged": _frozen_adam, "half_batch": _half_batch_lm,
     "token_altered": _altered_token}[fault](monkeypatch)
    _, checks = _run(_lm_cell(), LM_SIZES)
    assert not checks.correct, checks.lines()
