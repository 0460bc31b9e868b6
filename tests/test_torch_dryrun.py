"""The port's multi-pod dry-run (``repro_torch.launch.dryrun``), the
counterparts of ``tests/test_dryrun.py``, run as SUBPROCESSES with
``--device cpu``: the dry-run starts a fake process group of 256 or 512
ranks, which must not outlive it in a test worker.

* chatglm3-6b x decode_32k on ``--mesh both`` prints both mesh lines and
  ``2 ok``; phi3-medium-14b x long_500k is the reference's documented
  skip; ``--fl`` prints the FL line and a record with the three terms and
  the collective bytes by kind (``--out``), the clients split over
  ``data`` as the reference shards them.
* On two pods the FL round splits over pod x data; ``--fl-shard-w``
  splits it over ``model``.
* Without a card and without ``--device cpu`` the CLI exits 1; a trace
  past its time limit (on by default) names the model code it was in.
* Importing the module starts no process group.
* Every kernel wrapper refuses a FakeTensor with a ValueError (the
  kernels read real memory).
* The train step of the encoder-decoder family (the sweep's
  seamless-m4t x train_4k) runs: a parameter the loss does not read gets a
  zero gradient.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import ops
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _run(*args, timeout=300, env=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **(env or {}))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


def test_dryrun_single_and_multi_pod():
    r = _run("--arch", "chatglm3-6b", "--shape", "decode_32k", "--mesh",
             "both", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[16x16] chatglm3-6b" in r.stdout
    assert "[2x16x16] chatglm3-6b" in r.stdout
    assert "2 ok" in r.stdout


def test_dryrun_skips_long500k_for_full_attention():
    r = _run("--arch", "phi3-medium-14b", "--shape", "long_500k",
             "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "1 skipped" in r.stdout


def test_dryrun_fl_round_at_scale(tmp_path):
    out = tmp_path / "fl.jsonl"
    r = _run("--fl", "--mesh", "both", "--device", "cpu", "--out", str(out))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FL coalition round" in r.stdout
    rec, pods = map(json.loads, out.read_text().splitlines())
    assert rec["status"] == "ok" and rec["chips"] == 256
    for key in ("compute_s", "memory_s", "collective_s"):
        assert rec[key] > 0.0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    # the clients split over data, as the reference shards them: a rank
    # counts 1/16 of the whole round that one rank runs alone (its 16
    # clients' training and a 16th of W's columns); the row blocks turn
    # into column tiles (all-to-all), the partial distances are summed
    # (all-reduce), θ is gathered (all-gather); the data axis's group
    # (every 16th rank) spans hosts
    assert rec["split"] == "data"
    whole = _case("fl_world1")
    assert rec["flops_per_device"] * 16 == pytest.approx(whole["flops"],
                                                         rel=1e-3)
    # on two pods over pod x data: 8 clients a rank
    assert pods["split"] == "pod_data" and pods["chips"] == 512
    assert pods["flops_per_device"] == pytest.approx(
        rec["flops_per_device"] / 2)
    assert {"all-to-all", "all-reduce", "all-gather"} <= set(rec["collectives"])
    assert rec["collectives"]["inter_host"] == rec["collectives"]["total"]


def test_dryrun_fl_split_over_the_mesh(tmp_path):
    """``--fl-shard-w`` splits the clients and W's columns over ``model``
    (16 consecutive ranks, two hosts) on both meshes, so two pods hold
    twice the replicas."""
    out = tmp_path / "fl.jsonl"
    r = _run("--fl", "--fl-shard-w", "--mesh", "both", "--device", "cpu",
             "--out", str(out))
    assert r.returncode == 0, r.stdout + r.stderr
    single, multi = map(json.loads, out.read_text().splitlines())
    assert single["split"] == multi["split"] == "model"
    assert {"all-to-all", "all-reduce", "all-gather"} <= set(
        single["collectives"])
    assert single["collectives"]["inter_host"] > 0
    assert multi["flops_per_device"] == single["flops_per_device"]
    assert multi["useful_ratio"] == pytest.approx(single["useful_ratio"] / 2)


def test_dryrun_needs_a_card_or_cpu():
    r = _run("--fl", env={"CUDA_VISIBLE_DEVICES": ""})      # no card seen
    assert r.returncode == 1
    assert "--device cpu" in r.stderr


def test_trace_time_limit_names_the_model_code():
    """The sweep's limit is on by default; past it the trace raises
    TraceTimeout naming the model frame it was in, and raises it again
    where the first raise is lost."""
    from repro_torch.launch import dryrun
    from repro_torch.models import layers

    class Endless(dict):
        """rmsnorm's params whose scale never comes: the time runs out
        inside models/layers.py"""

        def __getitem__(self, key):
            while True:
                pass

    assert dryrun.TRACE_TIMEOUT_S > 0
    x = torch.ones(4, 8)
    with pytest.raises(dryrun.TraceTimeout, match=r"models/layers\.py"):
        with dryrun._time_limit(0.05):
            layers.rmsnorm(Endless(), x)
    # a raise dropped on the way (as a weakref finalizer drops it) comes
    # again a second later
    dropped = 0
    with pytest.raises(dryrun.TraceTimeout):
        with dryrun._time_limit(0.05):
            while True:
                try:
                    layers.rmsnorm(Endless(), x)
                except dryrun.TraceTimeout:
                    if dropped:
                        raise
                    dropped += 1
    assert dropped == 1


def _case(name):
    """One case of ``_torch_dryrun_cases.py``, run as a subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.join(HERE,
                                                     "_torch_dryrun_cases.py"),
                        name], capture_output=True, text=True,
                       timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_import_starts_no_process_group():
    assert _case("import") == {"initialized": False}


def test_train_step_of_the_encoder_decoder_family():
    """The sweep's train step on seamless-m4t (reduced): its top-level
    modal projector, which the loss does not read (the encoder has its
    own), gets a zero gradient, as jax.grad gives it, and the step runs."""
    from repro_torch.configs import get, reduced
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf

    cfg = reduced(get("seamless-m4t-large-v2"))
    model = tf.init(torch.Generator().manual_seed(0), cfg)
    step, opt = steps.make_train_step(cfg, optimizer="adam", remat=True)
    state = opt.init(dict(model.named_parameters()))
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 9), generator=gen),
             "modal": torch.randn((2, cfg.n_modal_tokens, cfg.d_modal),
                                  generator=gen)}
    proj = model.proj.detach().clone()
    losses = [float(step(model, state, batch)) for _ in range(2)]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert losses[1] < losses[0]
    assert torch.equal(model.proj.detach(), proj)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", ["center_sq_dists", "fused_coalition_stats",
                                  "pairwise_sq_dists", "sq_dists_to_points",
                                  "segment_sum", "flash_attention"])
def test_kernel_wrappers_refuse_fake_tensors(name, device):
    with FakeTensorMode():
        w = torch.empty((10, 64), device=device)
        m = torch.empty((3, 10), device=device)
        q = torch.empty((1, 2, 8, 16), device=device)
        args = {"center_sq_dists": (w, m), "fused_coalition_stats": (w, m),
                "pairwise_sq_dists": (w,),
                "sq_dists_to_points": (w, torch.empty((3, 64),
                                                      device=device)),
                "segment_sum": (m, w), "flash_attention": (q, q, q)}[name]
        with pytest.raises(ValueError, match="FakeTensor"):
            getattr(ops, name)(*args)
