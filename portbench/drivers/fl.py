"""Driver ``fl``: federated rounds through ``Federation.run``, the path
``train --mode fl`` takes.

Set-up makes the data, the client split and θ0 from the seed on the
device, builds the federation the traffic file names, and warms it with a
short run of its own (every shape of the window: round 0's Step I, a later
round, the evaluation, the kernels' build).  The window is one
``Federation.run`` of R rounds, R sized from the warm rounds to last
``--seconds``; ``fl_samples_per_s`` is N·n·E·R over its seconds.  A
``--trace 1`` run then profiles a run of ``trace_rounds`` rounds.

The comparison follows the program from its own state at two rounds of
the window, round 0 and the last, recorded where the round loop hands
them on (``Federation._local_phase``, the strategy's ``round``): at both,
the server step (Step I from the replayed permutation at round 0, then
assignment, counts, next centres and θ against :mod:`reference.coalition`
on the program's W); at the last, the clients' rows of W after their
local SGD (a sample of clients drawn from the seed, each against
:func:`reference.cnn.client_update` from the round's θ with the shuffles
replayed from the run's generator); and the hand-off of θ to the next
round and to the caller.

The local phase is compared at the last round, on ``check_clients``
clients.  Round 0 starts from a fresh θ0, where 60 SGD steps amplify any
rounding (a ReLU or a pooling window that flips) to a few percent of a
client's update whatever the precision (PERF.md: the median client reads
5e-5 to 4e-3 in f32, 0.013 to 0.021 under TF32); a trained θ damps that,
and at the last round f32 and TF32 part a hundredfold.  Two numbers: the
worst sampled client (a fault in any one client's rows) and the median
one (a precision the whole cohort shares).

``control=True`` runs the cell's control in the program's place: the
program with its TF32 path on (cuDNN and cuBLAS), as a change of the
local phase's precision would run it, and each round's θ replaced by the
reference's barycenters taken as one TF32 product over the program's W.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench.harness import check, profile, spec, traffic, yardstick


class _Strategy:
    """The federation's strategy, with its ``round`` recorded (and, in a
    control run, its θ replaced by :func:`tf32_theta`)."""

    def __init__(self, inner, rec: "_Recorder"):
        self._inner, self._rec = inner, rec

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def round(self, w, state, mask=None):
        res = self._inner.round(w, state, mask=mask)
        if self._rec.control:
            res = res._replace(theta=tf32_theta(
                w, res.metrics.assignment, len(res.metrics.counts)))
        r = self._rec.current
        if r in self._rec.keep:
            self._rec.rounds[r].update(
                centers_in=state.center_idx, theta=res.theta,
                assignment=res.metrics.assignment, counts=res.metrics.counts,
                centers_out=res.state.center_idx)
        return res


class _Recorder:
    """What the timed run's rounds ``keep`` produced: θ handed in, W (for
    the rounds in ``full``), the server step's input state and result."""

    def __init__(self, fed, keep: set[int], full: set[int],
                 control: bool = False):
        self.keep, self.full, self.rounds, self.current = keep, full, {}, -1
        self.control = control
        local = fed._local_phase

        def local_phase(r, gp, client_data, perms, *rest):
            w, losses = local(r, gp, client_data, perms, *rest)
            self.current = r
            if r in keep:
                self.rounds[r] = {"theta_in": gp}
                if r in full:
                    self.rounds[r]["w"] = w
            return w, losses

        fed._local_phase = local_phase
        fed.strategy = _Strategy(fed.strategy, self)


def tf32_theta(w: torch.Tensor, assignment: torch.Tensor,
               k: int) -> torch.Tensor:
    """The control's server step: Algorithm 1's θ from the program's
    assignment, its barycenters one product over W (TF32: the control run
    has it on; each centre is a member of its own coalition, so no count
    is 0)."""
    mix = torch.nn.functional.one_hot(assignment.long(), k).T.to(w.dtype)
    bary = (mix / mix.sum(1, keepdim=True)) @ w
    return bary.mean(0)


def _federation(model, eval_fn, t: dict, rounds: int):
    from repro_torch.core import strategies
    from repro_torch.core.client import ClientConfig
    from repro_torch.core.server import Federation, FederationConfig

    cfg = FederationConfig(
        n_clients=t["n_clients"], n_coalitions=t["n_coalitions"],
        rounds=rounds, method=t["method"],
        client=ClientConfig(epochs=t["epochs"], batch_size=t["batch_size"],
                            lr=t["lr"]),
        backend=t["backend"], engine=t["engine"])
    strat = strategies.make_strategy(
        t["method"], n_clients=t["n_clients"],
        n_coalitions=t["n_coalitions"], backend=t["backend"])
    return Federation(model, eval_fn, cfg, strategy=strat)


def run(cell: spec.Cell, *, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, sizes: dict | None = None,
        control: bool = False) -> check.Outcome:
    """One run of an ``fl`` cell (``sizes`` overrides traffic parameters,
    for the CPU tests; ``control`` runs the cell's control)."""
    from repro_torch.models import zoo

    t = {**cell.traffic, **(sizes or {})}
    cnn = spec.load_module("reference", cell.config["reference"])
    # the configuration states f32, as run_fl sets it; the control is TF32
    _tf32(control)
    phases = {"before_data": time.perf_counter() - t_start}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    data = traffic.fl_images(t, seed, device)
    clients = {"x": data["x"], "y": data["y"]}
    theta0 = cnn.initial(seed, device)
    model = zoo.make_model(cell.config["model"])
    shapes = {k: tuple(v.shape) for k, v in
              model.init(torch.Generator().manual_seed(0)).items()}
    if shapes != {k: s for k, s, _ in cnn.PARAMS}:
        raise RuntimeError(f"the program's {cell.config['model']} has "
                           f"parameters {shapes}, not the configuration's")

    def eval_fn(p):
        return model.accuracy(p, data["test_x"], data["test_y"])

    phases["data"] = time.perf_counter() - t_start - sum(phases.values())
    warm = _federation(model, eval_fn, t, t["warm_rounds"])
    _, wh = warm.run(theta0, clients, generator=torch.Generator().manual_seed(
        traffic.stream_seed(seed, "warm")))
    phases["warm"] = time.perf_counter() - t_start - sum(phases.values())
    round_s = float(np.median(wh.trace.local_s[1:] + wh.trace.server_s[1:]))
    rounds = max(3, round(seconds / round_s))
    fed = _federation(model, eval_fn, t, rounds)
    rec = _Recorder(fed, keep={0, rounds - 2, rounds - 1},
                    full={0, rounds - 1}, control=control)
    gen = torch.Generator().manual_seed(traffic.stream_seed(seed, "shuffles"))
    profile.sync(device)
    t0 = time.perf_counter()
    gp, hist = fed.run(theta0, clients, generator=gen)
    profile.sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    samples = t["n_clients"] * t["n_local"] * t["epochs"] * rounds
    ctx = {"cell": cell, "traffic": t, "window_s": window_s,
           "rounds": rounds, "samples": samples, "phases": phases,
           "local_s": hist.trace.local_s.tolist(),
           "server_s": hist.trace.server_s.tolist(),
           "flops": samples * yardstick.cnn_sample_flops(), "trace": None}
    if trace:
        traced = _federation(model, eval_fn, t, t["trace_rounds"])

        def work():
            traced.run(theta0, clients, generator=torch.Generator()
                       .manual_seed(traffic.stream_seed(seed, "warm")))
            return t["trace_rounds"]

        ctx["trace"] = profile.traced(work, device)
    failed = int(np.sum(~np.isfinite(hist.trace.loss)
                        | ~np.isfinite(hist.trace.acc)))

    def verify() -> check.Checks:
        _tf32(False)
        return _verify(cell, t, seed, cnn, data, theta0, rec, gp, rounds)

    return check.Outcome(
        attempted=rounds, failed=failed,
        end_to_end={"fl_samples_per_s": samples / window_s,
                    "peak_mem_gib": peak / 2 ** 30,
                    "setup_s": t0 - t_start},
        ctx=ctx, memory_peak_bytes=peak, verify=verify)


def replay_shuffles(seed: int, t: dict, rounds: int, wanted: set[int]):
    """The run generator's draws, as ``Federation.run`` makes them: each
    round's (N, E, n) uniforms, argsorted into the epochs' sample orders,
    and after round 0's the Step-I permutation of the clients."""
    g = torch.Generator().manual_seed(traffic.stream_seed(seed, "shuffles"))
    perms, perm0 = {}, None
    for r in range(rounds):
        u = torch.rand((t["n_clients"], t["epochs"], t["n_local"]),
                       generator=g)
        if r in wanted:
            perms[r] = torch.argsort(u, dim=-1)
        if r == 0:
            perm0 = torch.randperm(t["n_clients"], generator=g).tolist()
    return perms, perm0


def client_gaps(cnn, theta: dict, rows, x, y, perms, t: dict,
                clients: list[int]) -> dict[int, dict]:
    """For each of ``clients``, each leaf's ‖program's update − the
    reference's‖ against the larger of the leaf's reference update norm
    and the median leaf's.  ``rows[c]`` is client c's row of W."""
    out = {}
    for c in clients:
        new = cnn.client_update(theta, x[c], y[c], perms[c].to(x.device),
                                t["batch_size"], t["lr"])
        prog = cnn.unflatten(rows[c])
        diff = {k: float(torch.linalg.vector_norm(prog[k] - new[k]))
                for k in new}
        base = {k: float(torch.linalg.vector_norm(new[k] - theta[k]))
                for k in new}
        out[c] = check.by_leaf(diff, base)
    return out


def _spread(gaps: dict[int, dict]) -> str:
    per = sorted(max(g.values()) for g in gaps.values())
    return " ".join(f"{v:.3g}" for v in per)


def _verify(cell, t, seed, cnn, data, theta0, rec, gp,
            rounds) -> check.Checks:
    from portbench.reference import coalition

    checks = check.Checks(cell.workload["limits"])
    last = rounds - 1
    perms, perm0 = replay_shuffles(seed, t, rounds, {last})
    pick = torch.randperm(t["n_clients"], generator=torch.Generator()
                          .manual_seed(traffic.stream_seed(seed, "check")))
    theta_gap, mismatches, handoff = 0.0, 0, 0.0
    for r in (0, last):
        got = rec.rounds[r]
        theta_in = theta0 if r == 0 else got["theta_in"]
        if r == 0:              # θ0 handed to round 0 as it was made
            handoff = max(handoff, max(float((got["theta_in"][k] - v)
                                             .abs().max())
                                       for k, v in theta0.items()))
        w = got["w"]
        if r == last:
            gaps = client_gaps(cnn, theta_in, w, data["x"], data["y"],
                               perms[r], t,
                               pick[:t["check_clients"]].tolist())
            worst = {k: max(g[k] for g in gaps.values())
                     for k in next(iter(gaps.values()))}
            checks.notes.append(f"round {r} sampled clients' gaps, sorted: "
                                f"{_spread(gaps)}; worst leaves "
                                f"{check.worst(worst)}")
            per_client = [max(g.values()) for g in gaps.values()]
            local = (max(per_client), statistics.median(per_client))
        if r == 0:
            centers = coalition.first_centers(w, perm0, t["n_coalitions"])
            mismatches += sum(a != b for a, b in
                              zip(centers, got["centers_in"].tolist()))
        else:
            centers = got["centers_in"].tolist()
        # the program's choices, each within a tie of the nearest, and the
        # rest of the round continued from them
        d2, allowed = coalition.assign(w, centers)
        mismatches += coalition.bad_choices(d2, got["assignment"], allowed)
        out = coalition.aggregate(w, centers, got["assignment"])
        mismatches += int((out["counts"] != got["counts"].double()).sum())
        mismatches += coalition.bad_choices(out["med"].T, got["centers_out"],
                                            out["member"].T)
        flat_in = cnn.flatten(theta_in).double()
        theta_gap = max(theta_gap, float(
            torch.linalg.vector_norm(got["theta"].double() - out["theta"])
            / torch.linalg.vector_norm(out["theta"] - flat_in)))
        del got["w"], w
    # θ handed to the last round and returned to the caller, as computed
    for want, have in ((rec.rounds[last - 1]["theta"],
                        rec.rounds[last]["theta_in"]),
                       (rec.rounds[last]["theta"], gp)):
        want = cnn.unflatten(want)
        handoff = max(handoff, max(float((have[k] - want[k]).abs().max())
                                   for k in want))
    checks.add("local_update_gap", local[0])
    checks.add("local_update_median", local[1])
    checks.add("theta_gap", theta_gap)
    checks.add("coalition_mismatches", mismatches)
    checks.add("handoff_gap", handoff)
    return checks


def control(cell: spec.Cell, seed: int, device: torch.device,
            seconds: float) -> dict:
    """One run of the cell's control (:func:`run` with ``control``), read
    by the cell's own comparison."""
    out = run(cell, seed=seed, seconds=seconds, trace=False, device=device,
              t_start=time.perf_counter(), control=True)
    checks = out.verify()
    return {"correct": checks.correct, "checks": checks.as_dict(),
            "notes": checks.notes}


def _tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
