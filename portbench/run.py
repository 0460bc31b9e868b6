"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell's driver (``drivers/<driver>.py``,
named by its traffic file) sets up from the seed, warms up, measures for
``--seconds`` and, with ``--trace 1``, profiles a short sub-window whose
per-layer metrics the readers under ``metrics/`` take.  Then the program's
state is freed and the plain reference decides ``correct``.  Each number
compared is printed beside its limit as the last lines on standard error
and under ``checks``, the last key of the JSON line that ends standard
output.

It exits non-zero and prints no result without enough CUDA cards, when a
module named ``jax``, ``jaxlib``, ``flax`` or ``repro`` (top-level names,
compared whole) is loaded once the window has closed, and when the
program (``src/``) is missing.  Build and kernel caches stay inside the
checkout: the port's nvcc builds in ``src/repro_torch/kernels/_build/``,
Triton's and torch's extension and compile caches under
``portbench/_cache/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
CACHE = ROOT / "portbench" / "_cache"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench.harness import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    driver = spec.load_module("drivers", cell.driver)
    out = driver.run(cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=device, t_start=T_START)
    result = {"correct": False, "attempted": out.attempted,
              "failed": out.failed}
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_module("metrics", m["name"]).read(out.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(device),
                        "count": cell.chips,
                        "memory_peak_bytes": out.memory_peak_bytes,
                        "power_limit": power_limit()}
    tr, summary = out.ctx.get("trace"), None
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
        summary = tr.summary()
        out.ctx["trace"] = tr = None
    t_check = time.perf_counter()
    checks = out.verify()
    if summary:
        checks.notes.append(summary)
    checks.notes.append(f"set-up seconds by phase {out.ctx['phases']}; "
                        f"comparison seconds {time.perf_counter() - t_check}")
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark must not load: {found}",
              file=sys.stderr)
        return 3
    result["correct"] = checks.correct and out.failed == 0
    result["checks"] = checks.as_dict()
    for line in checks.lines():
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
