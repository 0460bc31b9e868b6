"""What the profiler costs an FL cell's rounds, with and without the
program's ``fl.*`` ranges.

    python3 scripts/profiler_cost.py --workload fl_cnn_cohort100 \
        --seed <n> [--reps 3] [--rounds 4]

Sets up as the benchmark's ``fl`` driver does (data, θ0 and the
federation from the seed, f32 with TF32 off, a warm run of the cell's
warm rounds), then runs one ``Federation.run`` of ``--rounds`` rounds in
each of three modes, ``--reps`` times, the order turned each time (off,
spans, bare, then bare, spans, off, ...): ``off`` untraced; ``spans``
under the profiler as a ``--trace 1`` run profiles its window
(``profile.traced``); ``bare`` the same with the program's
``record_function`` replaced by a null context, as a program without the
ranges runs.  Each run prints one JSON line: each round's ``local_s +
server_s`` and their median over the rounds after round 0 (which runs
Step I), and the run's seconds a round.  The last line gives each mode's
medians and each traced mode's cost against ``off``.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
MODES = ("off", "spans", "bare")


def measure(cell, seed: int, device, reps: int, rounds: int,
            sizes: dict | None = None, out=sys.stdout) -> dict:
    """Run the modes ``reps`` times each; return the summary line (each
    mode's median round and run seconds a round, in ms, and the traced
    modes' cost against ``off``)."""
    import torch

    from portbench.harness import profile, spec, traffic
    from repro_torch.core import server
    from repro_torch.models import zoo

    driver = spec.load_module("drivers", cell.driver)
    t = {**cell.traffic, **(sizes or {})}
    driver._tf32(False)
    data = traffic.fl_images(t, seed, device)
    clients = {"x": data["x"], "y": data["y"]}
    theta0 = spec.load_module("reference",
                              cell.config["reference"]).initial(seed, device)
    model = zoo.make_model(cell.config["model"])

    def eval_fn(p):
        return model.accuracy(p, data["test_x"], data["test_y"])

    def one(n_rounds: int) -> tuple[list[float], float]:
        fed = driver._federation(model, eval_fn, t, n_rounds)
        gen = torch.Generator().manual_seed(
            traffic.stream_seed(seed, "shuffles"))
        t0 = time.perf_counter()
        _, hist = fed.run(theta0, clients, generator=gen)
        profile.sync(device)
        wall = time.perf_counter() - t0
        return (hist.trace.local_s + hist.trace.server_s).tolist(), wall

    one(t["warm_rounds"])
    got: dict[str, list[tuple[float, float]]] = {m: [] for m in MODES}
    for rep in range(reps):
        for mode in (MODES if rep % 2 == 0 else MODES[::-1]):
            res = {}
            if mode == "off":
                res["r"] = one(rounds)
            else:
                def work():
                    res["r"] = one(rounds)
                    return rounds

                bare = mock.patch.object(
                    server, "record_function",
                    lambda name: contextlib.nullcontext())
                with bare if mode == "bare" else contextlib.nullcontext():
                    profile.traced(work, device)
            per_round, wall = res["r"]
            med = statistics.median(per_round[1:])
            got[mode].append((med, wall / rounds))
            print(json.dumps({"mode": mode, "rep": rep,
                              "round_s": per_round,
                              "median_round_ms": 1e3 * med,
                              "run_ms_per_round": 1e3 * wall / rounds}),
                  file=out, flush=True)
    summary = {m: {"median_round_ms": 1e3 * statistics.median(
                       v[0] for v in got[m]),
                   "run_ms_per_round": 1e3 * statistics.median(
                       v[1] for v in got[m])} for m in MODES}
    for m in ("spans", "bare"):
        summary[m]["cost_ms"] = (summary[m]["median_round_ms"]
                                 - summary["off"]["median_round_ms"])
    print(json.dumps({"summary": summary}), file=out, flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench.harness import spec

    if not torch.cuda.is_available():
        print("the profiler's cost is read on a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)            # as run.py runs a cell
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    measure(spec.cell(args.workload), args.seed, device, args.reps,
            args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
