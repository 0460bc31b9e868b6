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
"""
import json
import sys


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
    elif case == "import":
        import torch.distributed as dist

        import repro_torch.launch.dryrun  # noqa: F401

        out = {"initialized": dist.is_initialized()}
    else:
        raise SystemExit(f"unknown case {case!r}")
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
