"""Cases of the port's dry-run tests that start a fake process group, run
as subprocesses (``python tests/_torch_dryrun_cases.py CASE``, PYTHONPATH
holding ``src``) so that no group outlives them in a test worker.  Each
prints one JSON object.  No JAX import: the process starts light.

  toy     a two-layer MLP's forward on a (4, 4) fake mesh, counted per
          rank beside the same forward unsharded
          (``repro_torch.testing.sharded_toy_flops``); at a hidden width
          that the model axis divides, and at one it does not (the weights
          then replicate, by the sharding rules' global rule)
  fl_world1  the FLOPs of the paper's N = 256 round (``stream``) that one
          rank runs alone (a fake group of one)
  import  whether importing the dry-run module starts a process group
  ssm_scan_mesh  the SSM scan operator's forward and backward on a (4, 4)
          fake mesh (the batch over ``data``, d_inner over ``model``, both
          divided by 4), counted per rank beside the same calls unsharded,
          with the placements DTensor chose and the fallback's counts
  ssm_train_4k  a train step of the reduced falcon-mamba-7b at S = 4096
          traced by ``dryrun.lm_step`` on a (2, 2) fake mesh under a time
          limit of SSM_TRACE_LIMIT_S
"""
import json
import sys
import time

#: seconds the reduced SSM train step's trace may take
SSM_TRACE_LIMIT_S = 60.0


def main(case: str) -> None:
    if case == "toy":
        from repro_torch.testing import sharded_toy_flops

        out = {"divides": sharded_toy_flops(128),
               "does_not_divide": sharded_toy_flops(130)}
    elif case == "fl_world1":
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch.launch import analysis, dryrun

        mesh = dryrun.fake_mesh({"data": 1, "model": 1}, "cpu")
        with FakeTensorMode():
            step, args, _ = dryrun.fl_round_step(mesh, device="cpu")
            counter = analysis.Counter()
            with dryrun.counted_step(counter):
                step(*args)
        out = {"flops": counter.flops}
    elif case == "ssm_scan_mesh":
        out = _ssm_scan_mesh()
    elif case == "ssm_train_4k":
        out = _ssm_train_4k()
    elif case == "import":
        import torch.distributed as dist

        import repro_torch.launch.dryrun  # noqa: F401

        out = {"initialized": dist.is_initialized()}
    else:
        raise SystemExit(f"unknown case {case!r}")
    print(json.dumps(out))


def _ssm_scan_mesh() -> dict:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import analysis, dryrun, sharding

    b, s, di, n, chunk = 8, 200, 64, 16, 64
    mesh = dryrun.fake_mesh({"data": 4, "model": 4}, "cpu")
    specs = {"delta": ("data", None, "model"), "u": ("data", None, "model"),
             "bmat": ("data", None, None), "cmat": ("data", None, None),
             "a": ("model", None), "h0": ("data", "model", None)}

    def fwd_bwd(t):
        y, h, _ = torch.ops.repro_torch.ssm_scan(*t.values(), chunk, True)
        grads = torch.autograd.grad((y, h), list(t.values()),
                                    (torch.ones_like(y), torch.ones_like(h)))
        return y, h, grads

    with FakeTensorMode():
        shapes = {"delta": (b, s, di), "u": (b, s, di), "bmat": (b, s, n),
                  "cmat": (b, s, n), "a": (di, n), "h0": (b, di, n)}
        whole_in = {k: torch.empty(v) for k, v in shapes.items()}
        placed = sharding.attach(specs, whole_in, mesh)
        for t in (*whole_in.values(), *placed.values()):
            t.requires_grad_()
        whole = analysis.Counter()
        with whole:
            fwd_bwd(whole_in)
        rank = analysis.Counter()
        with dryrun.counted_step(rank) as reshard:
            y, h, grads = fwd_bwd(placed)
    return {"whole_flops": whole.flops, "rank_flops": rank.flops,
            "resharded": dict(reshard.counts),
            "collective_bytes": rank.collective_bytes,
            "y": [repr(p) for p in y.placements],
            "h_last": [repr(p) for p in h.placements],
            "grads": [[repr(p) for p in g.placements] for g in grads]}


def _ssm_train_4k() -> dict:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get, reduced
    from repro_torch.launch import dryrun

    cfg = reduced(get("falcon-mamba-7b"))
    mesh = dryrun.fake_mesh({"data": 2, "model": 2}, "cpu")
    t0 = time.time()
    with dryrun._time_limit(SSM_TRACE_LIMIT_S), FakeTensorMode():
        tokens = torch.empty((4, 4096), dtype=torch.int32)
        step, args = dryrun.lm_step(cfg, "train", mesh,
                                    {"batch": {"tokens": tokens}},
                                    device="cpu")
        roof, resharded, trace_s = dryrun._count(
            step, args, chips=4, model_flops_global=1.0)
    return {"status": "ok", "trace_s": trace_s,
            "total_s": time.time() - t0, "limit_s": SSM_TRACE_LIMIT_S,
            "flops": roof["flops_per_device"], "resharded": resharded}


if __name__ == "__main__":
    main(sys.argv[1])
