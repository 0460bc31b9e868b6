"""The yardstick's operations and bytes against the hand-worked figures,
and the traffic generator's determinism."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench.harness import check, profile, traffic, yardstick  # noqa: E402

HYMBA = json.loads((ROOT / "portbench/configs/hymba-1.5b.json").read_text())


def test_cnn_sample_flops():
    assert sum(yardstick.cnn_forward_macs().values()) * 2 == 8_534_016
    assert yardstick.cnn_sample_flops() == 24_680_448


def test_hymba_step_flops_match_the_traced_step():
    # a world-1 hymba Adam step at 10 x 129 traced 1.257711e13 FLOPs
    got = yardstick.lm_step_flops(HYMBA, 10, 129)
    assert abs(got / 1.257711e13 - 1) < 0.01
    assert yardstick.lm_linear_params(HYMBA) < HYMBA["n_params"]


def test_flash_bytes_and_ops():
    nbytes, ops = yardstick.flash_bytes_ops(10, 25, 5, 129, 64, 1024)
    assert nbytes == 9_907_200                     # 9.91 MB
    assert ops == 4 * 10 * 25 * 64 * 8385          # 5.37e8
    assert yardstick.attention_pairs(4096, 1024) == 3_670_528
    least = yardstick.roofline_s(nbytes, ops, yardstick.PEAK_FLOPS["bf16"])
    assert least == pytest.approx(nbytes / 3.35e12)


def test_fused_round_bytes():
    n, k, d = 128, 3, 582_026
    assert yardstick.fused_round_bytes(n, k, d) == \
        2 * n * d * 4 + 2 * 4 * 2 * n * k + 4 * (k * d + d)


def test_traffic_is_deterministic_in_large_seeds():
    seed = 2 ** 40 + 12345
    t = {"n_clients": 4, "n_local": 200, "n_test": 30,
         "shards_per_client": 2}
    a = traffic.fl_images(t, seed, "cpu")
    b = traffic.fl_images(t, seed, "cpu")
    c = traffic.fl_images(t, seed + 1, "cpu")
    assert a["x"].shape == (4, 200, 28, 28, 1) and a["y"].shape == (4, 200)
    assert a["test_x"].shape == (30, 28, 28, 1)
    assert torch.equal(a["x"], b["x"]) and torch.equal(a["y"], b["y"])
    assert not torch.equal(a["x"], c["x"])
    assert float(a["x"].min()) >= 0.0 and float(a["x"].max()) <= 1.0
    rows = traffic.lm_rows(6, 17, 50, seed, "cpu")
    assert torch.equal(rows, traffic.lm_rows(6, 17, 50, seed, "cpu"))
    assert rows.shape == (6, 17) and int(rows.max()) < 50


def test_label_shards_partition_the_sorted_samples():
    y = torch.arange(40) // 4                      # already sorted
    idx = traffic.label_shards(y, 4, 2, 10, torch.Generator().manual_seed(1))
    assert idx.shape == (4, 10)
    assert sorted(idx.flatten().tolist()) == list(range(40))
    for row in idx.tolist():                       # two runs of 5 indices
        row = sorted(row)
        assert row[4] - row[0] == 4 and row[9] - row[5] == 4
        assert row[0] % 5 == 0 and row[5] % 5 == 0


def test_normal_stream_hands_out_its_total_in_order():
    g = torch.Generator().manual_seed(3)
    s = traffic.NormalStream(g, 10, chunk=4)
    parts = torch.cat([s.take(3), s.take(5), s.take(2)])
    want = torch.cat([torch.randn(4, generator=torch.Generator()
                                  .manual_seed(3))])
    assert torch.equal(parts[:4], want)
    with pytest.raises(ValueError):
        s.take(1)


def test_trace_reduction():
    tr = profile.Trace(
        window_s=1.0,
        device=[("k_a", 0.0, 0.2, 7), ("k_b", 0.1, 0.3, 8),
                ("Memcpy HtoD", 0.5, 0.6, 7)],
        host=[("aten::mm", 0.0, 0.9), ("aten::item", 0.3, 0.45)],
        steps=2)
    assert tr.busy_s() == pytest.approx(0.4)
    assert tr.kernels() == 2
    assert tr.device_total("k_") == (pytest.approx(0.4), 2)
    assert tr.host_total(("aten::mm",)) == pytest.approx(0.9)
    assert tr.idle_gaps(1) == [["aten::item", pytest.approx(0.2)]]
    # the overlap of k_a and k_b is split between them
    top = tr.top_device_ops()
    assert top == [["k_a", pytest.approx(0.15)], ["k_b", pytest.approx(0.15)],
                   ["Memcpy_HtoD", pytest.approx(0.1)]]
    assert sum(t for _, t in top) == pytest.approx(tr.busy_s())
    assert "records by stream {7: 2, 8: 1}" in tr.summary()


class _Event:
    def __init__(self, **kw):
        self.kw = kw

    def __getattr__(self, name):
        if name not in self.kw:
            raise AttributeError(name)
        return lambda: self.kw[name]


@pytest.mark.parametrize("event,annotation", [
    (_Event(activity_type="kernel"), False),
    (_Event(activity_type="gpu_memcpy"), False),
    (_Event(activity_type="gpu_memset"), False),
    (_Event(activity_type="gpu_user_annotation"), True),
    (_Event(is_user_annotation=True), True),
    (_Event(is_user_annotation=False), False)],
    ids=["kernel", "memcpy", "memset", "annotation", "user-old",
         "kernel-old"])
def test_device_annotations_are_told_apart(event, annotation):
    assert profile._annotation(event) is annotation


def test_a_null_limit_passes_nothing():
    checks = check.Checks({"a": 0.1, "b": None})
    checks.add("a", 0.05)
    assert checks.correct
    checks.add("b", 0.0)
    assert not checks.correct
    assert checks.lines()[-1].endswith("FAIL")
