"""The port's roofline analysis (``repro_torch.launch.analysis``).

* The roofline arithmetic on the H100's constants and the choice of
  bottleneck; the record's keys.
* The mapping of ``c10d`` / ``_c10d_functional`` ops to the reference's
  five collective kinds, and of a group's ranks to one host (NVLink) or
  more (the NIC).
* The counter on the paper CNN's local phase: the vmapped per-client
  gradients of N clients count the FLOPs of the looped ones (N = 1, 4,
  16), where ``torch.utils.flop_counter`` alone over-counts the vmapped
  (grouped) convolution backward; a real run counts what the fake one
  does; views cost no bytes; the peak follows the live bytes over those
  held at the start, frees of held state included.
* DTensor's sharding propagation is wrapped (its ops left uncounted) only
  while a Counter is open, and a torch that lacks a wrapped entry point
  makes the Counter raise.
* On a (4, 4) fake mesh (a subprocess, ``tests/_torch_dryrun_cases.py``)
  a toy whose every dim divides counts per rank 1/16 of its unsharded
  FLOPs; with a dim that does not divide, the product is greater and
  ``useful_ratio`` below 1.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch import analysis
from repro_torch.models import cnn
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ops = torch.ops


def _counter(flops=0, nbytes=0, intra=0, inter=0):
    c = analysis.Counter()
    c.flops, c.bytes = flops, nbytes
    c.collectives["all-gather"] = intra + inter
    c.collectives["intra_host"], c.collectives["inter_host"] = intra, inter
    return c


@pytest.mark.parametrize("flops,nbytes,intra,inter,bottleneck", [
    (989e12, 1e9, 0, 0, "compute"),
    (1e9, 6.7e12, 450e9, 0, "memory"),
    (1e9, 1e9, 450e9, 100e9, "collective"),
])
def test_roofline_terms(flops, nbytes, intra, inter, bottleneck):
    c = _counter(flops, nbytes, intra, inter)
    r = analysis.roofline(c, chips=256, model_flops_global=flops * 128,
                          memory={"temp_size_in_bytes": 7})
    assert r["compute_s"] == pytest.approx(flops / 989e12)
    assert r["memory_s"] == pytest.approx(nbytes / 3.35e12)
    assert r["collective_s"] == pytest.approx(intra / 450e9 + inter / 50e9)
    assert r["bottleneck"] == bottleneck
    assert r["hlo_flops_global"] == flops * 256
    assert r["useful_ratio"] == pytest.approx(0.5)
    assert r["collective_bytes_per_device"] == intra + inter
    assert r["collective_breakdown"]["total"] == intra + inter
    assert r["memory_analysis"] == {"temp_size_in_bytes": 7}
    assert {"chips", "flops_per_device", "bytes_per_device",
            "model_flops_global"} <= set(r)


def test_constants_are_the_h100s():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.NVLINK_BW,
            analysis.NIC_BW, analysis.HOST_CARDS) == \
        (989e12, 3.35e12, 450e9, 50e9, 8)


@pytest.mark.parametrize("op,kind", [
    (ops._c10d_functional.all_gather_into_tensor.default, "all-gather"),
    (ops._c10d_functional.all_reduce.default, "all-reduce"),
    (ops._c10d_functional.reduce_scatter_tensor.default, "reduce-scatter"),
    (ops._c10d_functional.all_to_all_single.default, "all-to-all"),
    (ops._c10d_functional.broadcast.default, "collective-permute"),
    (ops.c10d.allgather_.default, "all-gather"),
    (ops.c10d._allgather_base_.default, "all-gather"),
    (ops.c10d.allreduce_.default, "all-reduce"),
    (ops.c10d.reduce_scatter_.default, "reduce-scatter"),
    (ops.c10d._reduce_scatter_base_.default, "reduce-scatter"),
    (ops.c10d.alltoall_base_.default, "all-to-all"),
    (ops.c10d.alltoall_.default, "all-to-all"),
    (ops.c10d.broadcast_.default, "collective-permute"),
    (ops._dtensor.shard_dim_alltoall.default, "all-to-all"),
    (ops._c10d_functional.wait_tensor.default, None),
    (ops.aten.mm.default, None),
])
def test_collective_kinds(op, kind):
    assert analysis.collective_kind(op) == kind


@pytest.mark.parametrize("ranks,one_host", [
    (range(8), True), (range(8, 16), True), ([3], True),
    (range(16), False), (range(0, 256, 16), False), ([7, 8], False),
])
def test_host_span(ranks, one_host):
    assert analysis.spans_one_host(list(ranks)) == one_host


def _client_grads(n: int, *, vmapped: bool, mode):
    """The CNN's per-client gradients of n clients at batch 32, vmapped or
    one client at a time, under ``mode``."""
    gen = torch.Generator().manual_seed(0)
    params = cnn.init(gen)
    stacked = {k: v[None].expand(n, *v.shape).clone()
               for k, v in params.items()}
    batch = {"x": torch.rand((n, 32, 28, 28, 1), generator=gen),
             "y": torch.randint(0, 10, (n, 32), generator=gen)}
    grad = torch.func.grad(cnn.loss_fn)
    with mode:
        if vmapped:
            torch.func.vmap(grad)(stacked, batch)
        else:
            for i in range(n):
                grad({k: v[i] for k, v in stacked.items()},
                     {k: v[i] for k, v in batch.items()})
    return mode


@pytest.mark.parametrize("n", [1, 4, 16])
def test_vmapped_cnn_gradient_counts_as_looped(n):
    with FakeTensorMode(allow_non_fake_inputs=True):
        vm = _client_grads(n, vmapped=True, mode=analysis.Counter())
        lp = _client_grads(n, vmapped=False, mode=analysis.Counter())
    assert lp.flops > 0
    assert vm.flops == pytest.approx(lp.flops, rel=0.01)


def test_flop_registry_alone_overcounts_the_vmapped_backward():
    """The trap the counter fixes: the registry counts a grouped
    convolution's weight gradient ``groups`` times over."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        vm = _client_grads(4, vmapped=True,
                           mode=FlopCounterMode(display=False))
        lp = _client_grads(4, vmapped=False,
                           mode=FlopCounterMode(display=False))
    assert vm.get_total_flops() > 1.5 * lp.get_total_flops()


def test_real_run_counts_what_the_fake_one_does():
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = _client_grads(2, vmapped=True, mode=analysis.Counter())
    real = _client_grads(2, vmapped=True, mode=analysis.Counter())
    assert (real.flops, real.bytes) == (fake.flops, fake.bytes)
    assert real.peak_bytes == fake.peak_bytes > 0


def test_bytes_views_and_peak():
    c = analysis.Counter()
    with FakeTensorMode(), c:
        a = torch.empty(1000)                    # allocates, moves nothing
        assert c.bytes == 0 and c.live_bytes == 4000
        b = a.view(10, 100).t()                  # views: free
        assert c.bytes == 0 and c.live_bytes == 4000
        s = b + 1.0                              # 4000 read, 4000 written
        assert c.bytes == 8000 and c.live_bytes == 8000
        del s
        assert c.live_bytes == 4000
        torch.mm(b, torch.empty(10, 5))          # (100, 10) @ (10, 5)
    assert c.peak_bytes == 8000
    assert c.flops == 2 * 100 * 10 * 5


def test_held_state_replaced_in_the_step():
    """An optimizer that replaces its state frees what was held at the
    start: with the state held, the peak is one new buffer, as the
    allocator's peak over the bytes allocated at the start would be."""
    state = {"m": torch.zeros(1000), "v": torch.zeros(1000)}
    c = analysis.Counter()
    c.hold(state)
    assert c.held_bytes == 8000
    with c:
        for k in state:
            state[k] = state[k] + 1.0
    assert c.peak_bytes == 4000
    assert c.live_bytes == 8000


def test_local_bytes_counts_each_storage_once():
    t = torch.zeros(100)
    assert analysis.local_bytes({"a": t, "b": t[10:], "c": torch.zeros(3)}) \
        == 412
    assert analysis.local_bytes([t, torch.ones(2)], exclude=[t]) == 8


def test_counter_marks_sharding_propagation_only_while_open():
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    prop = DTensor._op_dispatcher.sharding_propagator
    before = (ShardingPropagator.propagate_op_sharding_non_cached,
              ShardingPropagator._propagate_tensor_meta_non_cached,
              prop.propagate_op_sharding)
    with analysis.Counter():
        with analysis.Counter():
            pass
        assert ShardingPropagator.propagate_op_sharding_non_cached \
            is not before[0]
        assert prop.propagate_op_sharding is not before[2]
    assert (ShardingPropagator.propagate_op_sharding_non_cached,
            ShardingPropagator._propagate_tensor_meta_non_cached,
            prop.propagate_op_sharding) == before


def test_counter_raises_without_the_propagation_it_wraps(monkeypatch):
    """A torch whose DTensor lacks an entry point the counter wraps would
    count DTensor's global-shaped shadow ops as rank work: it raises."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    monkeypatch.delattr(ShardingPropagator,
                        "_propagate_tensor_meta_non_cached")
    with pytest.raises(RuntimeError, match="_propagate_tensor_meta"):
        with analysis.Counter():
            pass
    assert not hasattr(ShardingPropagator,
                       "_propagate_tensor_meta_non_cached")


def test_per_rank_flops_on_a_fake_mesh():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.join(HERE,
                                                     "_torch_dryrun_cases.py"),
                        "toy"], capture_output=True, text=True, timeout=300,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    even, odd = out["divides"], out["does_not_divide"]
    assert even["rank_flops"] * 16 == even["global_flops"]
    assert even["useful_ratio"] == pytest.approx(1.0)
    assert odd["rank_flops"] * 16 > odd["global_flops"]
    assert odd["useful_ratio"] <= 1.0
    assert odd["useful_ratio"] == pytest.approx(0.25)
