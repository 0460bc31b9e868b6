"""Read a cell's comparison on the card, at the cell's own size, with its
lower-precision control or a planted fault in the program's place, or with
the program as it is.

    python3 portbench/controls.py --workload <cell> --seeds 1 2 3 \
        [--seconds <s>] [--program | --fault half_batch]

Each seed prints one JSON line: ``correct`` and the numbers the cell
compares, each beside its limit, and the comparison's notes; each run
lasts BENCHMARK.json's ``run_seconds`` unless ``--seconds`` says.  By default
the driver's ``control`` runs (for ``fl``: the program with its TF32 path
on and the server step's θ a TF32 product, through the run and the
comparison of a benchmark run).  ``--program`` reads the program as it
is, several seeds in one process (the lower readings of each limit);
``--fault half_batch`` plants the half-batch fault in the program (each
local step's loss the mean over the first half of its batch).  The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def half_batch_fl() -> None:
    """Plant the half-batch fault in the program's CNN."""
    from repro_torch.models import zoo

    model = zoo.make_model("cnn")

    def loss(p, batch):
        half = {k: v[:max(1, v.shape[0] // 2)] for k, v in batch.items()}
        return model.loss_fn(p, half)

    zoo._REGISTRY["cnn"] = model._replace(loss_fn=loss)


FAULTS = {"half_batch": half_batch_fl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--program", action="store_true")
    mode.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench.harness import spec

    if not torch.cuda.is_available():
        print("the controls are read on a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    seconds = args.seconds or float(spec.load_benchmark()["run_seconds"])
    driver = spec.load_module("drivers", cell.driver)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if args.fault:
        FAULTS[args.fault]()
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.program or args.fault:
            out = driver.run(cell, seed=seed, seconds=seconds,
                             trace=False, device=device, t_start=t0)
            checks = out.verify()
            read = {"correct": checks.correct, "checks": checks.as_dict(),
                    "notes": checks.notes,
                    "end_to_end": out.end_to_end}
        else:
            read = driver.control(cell, seed, device, seconds)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "mode": args.fault or ("program" if args.program
                                                 else "control"),
                          "seconds": time.perf_counter() - t0, **read}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
