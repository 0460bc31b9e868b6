"""Driver ``pretrain``: LM train steps through
``launch/steps.make_train_step``, the path ``train --mode pretrain``
takes.

Set-up builds the program's model for the configuration, loads the
benchmark's weights (made from the seed on the device), makes a pool of
token rows from the seed, and drives the step object through its first
:data:`WARM` steps on fresh rows, through the window's own call and feed
(the warm-up: every shape of the window).  It keeps each of those steps'
loss, the norm of each leaf's gradient as the optimizer got it at step 1
(Adam's m / (1 - b1)) and of each leaf's change from the initial weights
after step :data:`WARM`.  The window then runs that same object on fresh
rows for ``--seconds``, the losses left on the device;
``train_tokens_per_s`` is rows × sequence × steps over the window's
seconds.  A ``--trace 1`` run then profiles ``trace_steps`` more steps.

The comparison: once the program's state is freed, the plain f32
reference (:mod:`reference.hymba`, the configuration's ``reference``)
takes the same :data:`WARM` steps from the same weights on the same rows;
each step's loss, step 1's gradient norms and the change after the last
step are compared leaf by leaf.

No cell of BENCHMARK.json runs this driver yet: at the traffic's learning
rate (``make_train_step``'s 1e-3) the program's bf16 Adam, which keeps no
f32 master weights, leaves every RMSNorm scale unmoved (``unmoved_leaves``), so no run of it
is sound and ``loss_gap`` and ``change_norm_gap`` have no limit
(``workloads/pretrain_hymba_s128.json``).
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from portbench.harness import check, profile, spec, traffic, yardstick

#: steps of the warm-up, through the window's own call and feed
WARM = 3
#: the program's Adam (``optim.adam`` defaults): m after one step is
#: (1 - b1) times the first gradient
ADAM_B1 = 0.9


def model_config(cfg: dict):
    """The program's ModelConfig with the configuration file's values."""
    from repro_torch.models.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def build(cell: spec.Cell, seed: int, device, t: dict):
    """The program's model with the benchmark's weights and its step."""
    from repro_torch.launch import steps
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf

    ref = spec.load_module("reference", cell.config["reference"])
    mcfg = model_config(cell.config)
    layers.set_flash_kernel(t["flash"])
    # the program's init draws a skeleton; the benchmark's weights replace it
    model = tf.init(torch.Generator(device=device).manual_seed(0), mcfg,
                    device=device)
    params = dict(model.named_parameters())
    want = {name: shape for name, shape, _, _ in ref.leaves(cell.config)}
    have = {k: tuple(v.shape) for k, v in params.items()}
    if have != want:
        raise RuntimeError("the program's parameters differ from the "
                           f"configuration's: {sorted(set(have) ^ set(want))}")
    with torch.no_grad():
        for name, value in ref.initial_leaves(cell.config, seed, device,
                                              layers.dtype_of(mcfg)):
            if params[name].dtype != value.dtype:
                raise RuntimeError(f"{name}: the program keeps "
                                   f"{params[name].dtype}, not {value.dtype}")
            params[name].copy_(value)
    step, opt = steps.make_train_step(mcfg, optimizer="adam", lr=t["lr"],
                                      remat=t["remat"])
    return ref, model, params, step, opt.init(params)


def run(cell: spec.Cell, *, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        sizes: dict | None = None) -> check.Outcome:
    t = {**cell.traffic, **(sizes or {})}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    b, s = t["batch"], t["seq"] + 1
    pool = WARM + t["pool_steps"]
    rows = traffic.lm_rows(b * pool, s, cell.config["vocab"], seed, device)
    t_b = time.perf_counter()
    ref, model, params, step, opt_state = build(cell, seed, device, t)
    phases = {"before_build": t_b - t_start, "build": time.perf_counter() - t_b}
    dtype = params["embed"].dtype
    kept = 0.0          # seconds set-up spends on the comparison's records

    def batch(i):
        return {"tokens": rows[(i % pool) * b:(i % pool + 1) * b]}

    first = [step(model, opt_state, batch(0))]
    # the comparison's record of step 1, before step 2 moves it
    profile.sync(device)
    t_k = time.perf_counter()
    with torch.no_grad():
        grad_norms = {k: torch.linalg.vector_norm(m) / (1 - ADAM_B1)
                      for k, m in opt_state["m"].items()}
    profile.sync(device)
    kept += time.perf_counter() - t_k
    for i in range(1, WARM):
        first.append(step(model, opt_state, batch(i)))
    profile.sync(device)
    t_k = time.perf_counter()
    with torch.no_grad():
        change = {k: torch.linalg.vector_norm(params[k].float() - v.float())
                  for k, v in ref.initial_leaves(cell.config, seed, device,
                                                 dtype)}
    profile.sync(device)
    kept += time.perf_counter() - t_k
    phases["first_steps"] = time.perf_counter() - t_start - kept - sum(
        phases.values())
    losses, i = [], WARM
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        losses.append(step(model, opt_state, batch(i)))
        i += 1
    profile.sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    n_steps = len(losses)
    ctx = {"cell": cell, "traffic": t, "window_s": window_s,
           "steps": n_steps, "phases": phases,
           "flops": n_steps * yardstick.lm_step_flops(cell.config, b, s),
           "trace": None}
    if trace:
        def work():
            for j in range(t["trace_steps"]):
                step(model, opt_state, batch(i + j))
            return t["trace_steps"]

        ctx["trace"] = profile.traced(work, device)
    window_losses = torch.stack(losses).float().cpu() if losses \
        else torch.zeros(0)
    failed = int((~torch.isfinite(window_losses)).sum())
    record = {"losses": [float(v) for v in first],
              "grad_norms": {k: float(v) for k, v in grad_norms.items()},
              "change": {k: float(v) for k, v in change.items()}}

    def verify() -> check.Checks:
        nonlocal model, params, opt_state
        del model, params, opt_state
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return compare(cell, record, reference(
            cell, ref, seed, device, t,
            [batch(i)["tokens"] for i in range(WARM)]))

    tokens = n_steps * b * s
    return check.Outcome(
        attempted=n_steps, failed=failed,
        end_to_end={"train_tokens_per_s": tokens / window_s,
                    "peak_mem_gib": peak / 2 ** 30,
                    "setup_s": t0 - t_start - kept},
        ctx=ctx, memory_peak_bytes=peak, verify=verify)


def reference(cell, ref, seed, device, t, batches, q=None) -> dict:
    """The reference's steps on ``batches`` from the seed's weights (as
    served, in the configuration's dtype, then widened), in f32 (or with
    the quantiser ``q`` in its linear layers)."""
    served = getattr(torch, cell.config["dtype"])
    params = {k: v.float() for k, v in
              ref.initial_leaves(cell.config, seed, device, served)}
    return ref.train(cell.config, params, batches, t["lr"], t["micro"],
                     q or ref.identity)


def compare(cell, prog: dict, want: dict) -> check.Checks:
    """Each step's loss, step 1's gradient norm and the parameters' change
    after the last step, the last two by the worst leaf (a leaf's gap
    against the larger of its reference norm and the median leaf's), and
    the leaves that the reference moves and the program leaves exactly
    where they were (a small leaf unmoved reads only its norm over the
    median leaf's in the change's gap).  Leaves whose reference gradient
    is under a thousandth of the median leaf's are left out of the
    change."""
    checks = check.Checks(cell.workload["limits"])
    g, c = want["grad_norms"], want["change"]
    med = statistics.median(g.values())
    skip = {k for k, v in g.items() if v < 1e-3 * med}
    grads = check.by_leaf({k: abs(prog["grad_norms"][k] - g[k]) for k in g},
                          g)
    change = check.by_leaf({k: abs(prog["change"][k] - c[k]) for k in c},
                           c, skip)
    losses = [abs(p / r - 1) for p, r in zip(prog["losses"],
                                             want["losses"])]
    unmoved = sorted(k for k in c if k not in skip and c[k] > 0
                     and prog["change"][k] == 0)
    checks.notes += [
        f"losses program {prog['losses']} reference {want['losses']}",
        f"median leaf: gradient gap {statistics.median(grads.values())}, "
        f"change gap {statistics.median(change.values())}",
        f"worst gradient leaves: {check.worst(grads)}",
        f"worst change leaves: {check.worst(change)}",
        f"leaves left out of the change: {sorted(skip)}",
        f"leaves the program left unmoved: {len(unmoved)} "
        f"({', '.join(unmoved[:8])}{', ...' if len(unmoved) > 8 else ''})"]
    checks.add("loss_gap", max(losses))
    checks.add("grad_norm_gap", max(grads.values()))
    checks.add("change_norm_gap", max(change.values()))
    checks.add("unmoved_leaves", len(unmoved))
    return checks


def control(cell: spec.Cell, seed: int, device: torch.device,
            seconds: float = 0.0, sizes: dict | None = None) -> dict:
    """The lower-precision control (the reference with fp8 linear layers
    in the program's place) and the half-batch fault (the reference
    trained on the first half of each batch), each read against the f32
    reference on the same rows (``seconds`` unused: a training cell's
    readings need no window)."""
    t = {**cell.traffic, **(sizes or {})}
    ref = spec.load_module("reference", cell.config["reference"])
    b, s = t["batch"], t["seq"] + 1
    rows = traffic.lm_rows(b * (WARM + t["pool_steps"]), s,
                           cell.config["vocab"], seed, device)
    batches = [rows[i * b:(i + 1) * b] for i in range(WARM)]
    want = reference(cell, ref, seed, device, t, batches)
    out = {}
    for name, run_ in (("fp8", lambda: reference(cell, ref, seed, device, t,
                                                 batches, ref.fp8)),
                       ("half_batch", lambda: reference(
                           cell, ref, seed, device, t,
                           [x[:b // 2] for x in batches]))):
        got = run_()
        out[name] = compare(cell, got, want).as_dict()
    return out
