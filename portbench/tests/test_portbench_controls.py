"""On the card: each cell's lower-precision control comes out as not
correct under the cell's own comparison, at the cell's own size (one
seed; ``portbench/controls.py`` reads three or more).  Marked ``cuda``:
without a card each test skips."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench.harness import spec  # noqa: E402


def _device():
    if not torch.cuda.is_available():
        pytest.skip("the controls are read on a CUDA card")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    return device


@pytest.mark.cuda
def test_fl_control_is_not_correct():
    device = _device()
    cell = spec.cell("fl_cnn_cohort100")
    out = spec.load_module("drivers", cell.driver).control(
        cell, 2 ** 34 + 17, device,
        float(spec.load_benchmark()["run_seconds"]))
    assert not out["correct"], out["checks"]
    for name in ("local_update_median", "theta_gap"):
        got = out["checks"][name]
        assert got["value"] > got["limit"], (name, got)


@pytest.mark.cuda
def test_pretrain_control_and_half_batch_fail():
    device = _device()
    name = "pretrain_hymba_s128"
    cell = spec.cell(name, spec.with_pending(name))
    out = spec.load_module("drivers", cell.driver).control(
        cell, 2 ** 34 + 19, device)
    limit = cell.workload["limits"]["grad_norm_gap"]
    for case in ("fp8", "half_batch"):
        assert out[case]["grad_norm_gap"]["value"] > limit, (case, out[case])
