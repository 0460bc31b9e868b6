"""Training entry point of the PyTorch port: ``--mode fl`` (federated) and
``--mode pretrain`` (LM pretraining).

``--mode fl`` is the paper's experiment: federated training of the
MNIST-surrogate CNN with coalition aggregation (Algorithm 1) or its FedAvg
baseline (``--method fedavg``, ``fedavg_weighted`` with
``--client-weights``, ``fedavg_trimmed`` with ``--trim``).  ``--engine
semi_async`` runs it over a simulated device fleet (``--fleet``,
``--participation``, ``--staleness``, ``--deadline``, ``--sim-seed``) and
adds the substrate block (``fleet``, ``sim_time_s``, ``wan_MB``,
``edge_MB``, ``mean_participation``) to the summary; ``--engine
event_driven`` runs it as continuous-time completion events under a
per-device energy budget (``--energy-budget``, ``--max-events``) and adds
the energy block (``energy_budget_j``, ``events``, ``final_sim_time_s``,
``energy_spent_j``, ``devices_exhausted``).  ``--scenario`` and ``--rho``
couple the fleet to the data partition (``correlated-skew``,
``correlated-quantity``).  ``--fleet-size N`` is cohort mode: each round
trains a cohort of ``--clients`` devices sampled from a fleet of N
(``scan``/``python``).  ``--attack`` with ``--adv-frac`` and ``--rho-adv``
compromises a fraction of the fleet and adds the attack block;
``--dp-clip`` and ``--dp-sigma`` turn on the DP client path and add the DP
block with its epsilon.  ``--model transformer_tiny`` federates the bf16
row-token transformer (W a bf16 (N, 27,626) matrix).  The host side:
``--snapshot-dir`` (``--snapshot-every``, ``--snapshot-keep``) publishes
each round's θ, coalition barycenters and assignment into a model store
that ``serve --mode fl`` serves; ``--ckpt-dir`` (``--ckpt-every``)
writes resumable checkpoints and ``--resume`` continues from the latest;
``--metrics-out`` (``--metrics-every``) streams the run ledger as JSONL,
``--trace-out`` writes its simulated-time Chrome trace (substrate
engines), ``--profile-dir`` a ``torch.profiler`` Chrome trace of the run
and ``--out`` the summary as JSON.  ``--mesh data=P`` splits the coalition
round along D over P ranks (:mod:`repro_torch.core.sharded`; P processes
under ``torchrun --nproc-per-node P``, one process is a world of one) and
adds ``mesh`` and ``backend_sharded`` to the summary; rank 0 alone prints
and writes.  ``--chunk`` sets the streaming sweeps' column tile.  It
prints the reference's JSON summary keys plus ``device``.

``--mode pretrain`` trains an LM of the zoo (``--arch``, default hymba-1.5b
at full size; ``--reduced`` for the 2-layer f32 variant) on
``synthetic.lm_tokens`` with Adam (``--optimizer adam``) or SGD momentum
0.9, ``--steps`` steps of ``--batch-size`` sequences of ``--seq-len`` + 1
tokens.  ``--flash`` routes attention through the hand-written flash
kernel.  It prints the reference's summary keys plus ``device`` and fails,
as the reference does, if the last loss is not below the first.

The run is on a CUDA card unless the caller passes ``--device cpu``; without
a card and without ``--device cpu`` it exits non-zero.  The f32 CNN runs
with TF32 off (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` both False) so it matches the f32
reference.  ``--backend cuda`` (the default) runs the coalition round
through the hand-written kernels (the fused round's two, or with a sketch
``sq_dists_to_points`` and ``segment_sum``); ``stream`` and ``dot`` run it in
plain PyTorch.  ``--sketch rproj|countsketch`` moves assignment and medoid
election onto an (N, S) sketch of the client weights (``--sketch-dim`` S,
default 256).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl --rounds 3
  PYTHONPATH=src python -m repro_torch.launch.train --mode pretrain --flash \
      --lr 1e-3 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --mode pretrain \
      --device cpu --reduced --steps 5 --lr 1e-3
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \
      --method coalition_topk --sketch rproj --sketch-dim 256
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl --device cpu \
      --regime shard --rounds 3 --clients 6 --coalitions 2 --local-epochs 1 \
      --n-train 600 --n-test 200
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl --method fedavg \
      --engine semi_async --rounds 3
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \
      --engine semi_async --fleet cellular-flaky --rounds 3
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \
      --engine event_driven --fleet cellular-flaky --energy-budget 50 \
      --max-events 4
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \
      --engine semi_async --fleet cellular-flaky --scenario correlated-skew \
      --regime dirichlet --rho 1.0 --rounds 3
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \
      --fleet cellular-flaky --fleet-size 1048576 --rounds 3
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \
      --attack sign_flip --adv-frac 0.2 --rounds 3
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl --rounds 10 \
      --snapshot-dir /tmp/fl-store --snapshot-every 2 \
      --ckpt-dir /tmp/fl-ckpt --ckpt-every 5
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \
      --model transformer_tiny --rounds 3
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl --mesh data=1
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --mode fl --device cpu --mesh data=2 --rounds 2 --clients 6 \
      --coalitions 2 --local-epochs 1 --n-train 600 --n-test 200
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.core import backends as bk
from repro_torch.core import sketch as sketch_mod
from repro_torch.core import strategies
from repro_torch.data import partition
from repro_torch.models import zoo as zoo_mod
from repro_torch.sim import attacks as sim_attacks


# which strategies consume each CLI hyper-parameter: factories tolerate
# unknown keywords, so without this check a mismatched flag would be ignored
# while still looking applied
_EXTRA_CONSUMERS = {
    "top_m": ("coalition_topk",),
    "trim": ("fedavg_trimmed",),
    "client_weights": ("fedavg_weighted", "coalition", "coalition_topk"),
    "chunk": ("coalition", "coalition_topk"),
    "sketch": ("coalition", "coalition_topk"),
    "sketch_dim": ("coalition", "coalition_topk"),
}


def _strategy_extras(args) -> dict:
    """Per-strategy hyper-parameters from the CLI (None = rule's default)."""
    extras = {}
    if args.top_m is not None:
        extras["top_m"] = args.top_m
    if args.trim is not None:
        extras["trim"] = args.trim
    if args.client_weights:
        extras["client_weights"] = torch.tensor(
            [float(v) for v in args.client_weights.split(",")],
            dtype=torch.float32)
    if args.chunk is not None:
        from repro_torch.core import fused

        try:
            extras["chunk"] = fused.resolve_chunk(args.chunk, 1)
        except ValueError as e:
            raise SystemExit(f"--chunk: {e}") from None
    if args.sketch != "identity":
        extras["sketch"] = args.sketch
        if args.sketch_dim is not None:
            extras["sketch_dim"] = args.sketch_dim
    elif args.sketch_dim is not None:
        raise SystemExit("--sketch-dim requires --sketch rproj|countsketch "
                         "(identity has no sketch dimension)")
    for name in extras:
        if args.method not in _EXTRA_CONSUMERS[name]:
            raise SystemExit(
                f"--{name.replace('_', '-')} applies only to "
                f"{_EXTRA_CONSUMERS[name]}, not --method {args.method}")
    return extras


def _finite(v: float, ndigits: int) -> float | None:
    """Round for JSON, mapping non-finite values to null (RFC 8259)."""
    return round(float(v), ndigits) if np.isfinite(v) else None


def _profiler(profile_dir: str | None, device: torch.device):
    """A ``torch.profiler`` context that writes a Chrome trace of the run
    into ``profile_dir`` (real hardware time; the simulated-time view is
    ``--trace-out``), or a null context."""
    if profile_dir is None:
        return contextlib.nullcontext()
    from torch import profiler

    os.makedirs(profile_dir, exist_ok=True)
    activities = [profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(profiler.ProfilerActivity.CUDA)
    return profiler.profile(
        activities=activities,
        on_trace_ready=lambda prof: prof.export_chrome_trace(
            os.path.join(profile_dir, "trace.json")))


def resolve_device(name: str) -> torch.device:
    """The run's device; a CUDA device must exist, there is no fallback."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to "
                         "run on the CPU")
    return device


#: what run_fl returns beside the printed summary: the reference's list of
#: rounds, the per-round seconds, the History, the final θ params and the
#: scenario's metadata (its permutation and ranks)
_UNPRINTED = ("rounds", "local_s", "server_s", "history", "params",
              "scenario_metadata")


def run_fl(args) -> dict:
    from repro_torch import sim
    from repro_torch.core.client import ClientConfig
    from repro_torch.core.server import Federation, FederationConfig
    from repro_torch.data import loader, synthetic
    from repro_torch.obs import privacy

    # a bad mesh spec or an undersized fleet fails before any data loads
    if args.mesh is not None:
        from repro_torch.launch import mesh as mesh_lib

        try:
            mesh_lib.check_spec(args.mesh)
        except ValueError as e:
            raise SystemExit(f"--mesh: {e}") from None
    if args.fleet_size is not None:
        if args.fleet_size < args.clients:
            raise SystemExit(f"--fleet-size {args.fleet_size} must be >= "
                             f"--clients {args.clients} (the per-round "
                             f"cohort is sampled from the fleet)")
        if args.engine not in ("scan", "python"):
            raise SystemExit("--fleet-size (cohort mode) requires --engine "
                             "scan or python")
    extras = _strategy_extras(args)
    device = resolve_device(args.device)
    rank = 0
    if args.mesh is not None:
        import torch.distributed as dist

        device = mesh_lib.init_distributed(device)
        rank = dist.get_rank()
        if rank == 0:
            print(f"torch.distributed: {dist.get_backend()} backend, world "
                  f"{dist.get_world_size()}, ranks on {device}",
                  file=sys.stderr)
    if "client_weights" in extras:      # on the run's device, once
        extras["client_weights"] = extras["client_weights"].to(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    data = synthetic.mnist_idx()
    source = "mnist-idx"
    if data is None:
        data = (synthetic.digits(args.n_train, seed=0),
                synthetic.digits(args.n_test, seed=1))
        source = "synthetic-digits"
    (xtr, ytr), (xte, yte) = data
    # joint fleet + data sampling: the scenario permutes which device holds
    # which shard; the engine samples the same fleet from fleet / sim_seed
    scn = sim.make_scenario(args.scenario, ytr, args.clients,
                            fleet=args.fleet, regime=args.regime,
                            rho=args.rho, seed=args.seed,
                            sim_seed=args.sim_seed)
    cd = {k: torch.from_numpy(v).to(device) for k, v in
          loader.client_datasets(xtr, ytr, scn.index_matrix).items()}
    xte_t = torch.from_numpy(xte).to(device)
    yte_t = torch.from_numpy(yte).to(device)

    cfg = FederationConfig(
        n_clients=args.clients, n_coalitions=args.coalitions,
        rounds=args.rounds, method=args.method,
        client=ClientConfig(epochs=args.local_epochs,
                            batch_size=args.batch_size, lr=args.lr,
                            dp_clip=args.dp_clip, dp_sigma=args.dp_sigma),
        backend=args.backend, engine=args.engine,
        fleet_size=args.fleet_size, attack=args.attack,
        adv_frac=args.adv_frac, rho_adv=args.rho_adv, mesh=args.mesh,
        sim=sim.SimConfig(fleet=args.fleet, participation=args.participation,
                          staleness_alpha=args.staleness,
                          deadline=args.deadline,
                          energy_budget=args.energy_budget,
                          max_events=args.max_events, seed=args.sim_seed,
                          scenario=args.scenario, rho=args.rho))
    strategy = strategies.make_strategy(
        args.method, n_clients=args.clients, n_coalitions=args.coalitions,
        backend=args.backend, **extras)
    model = zoo_mod.make_model(args.model)
    # one CPU generator per run: the model's init, then the federation's
    # draws
    gen = torch.Generator().manual_seed(args.seed)
    params = model.init(gen, device=device)
    store = None
    if args.snapshot_dir is not None:
        from repro_torch.serve import ModelStore

        store = ModelStore(args.snapshot_dir, keep=args.snapshot_keep)
    t0 = time.time()
    fed = Federation(model, lambda p: model.accuracy(p, xte_t, yte_t), cfg,
                     strategy=strategy)
    # --ckpt-dir without --ckpt-every still checkpoints (round 0 + final);
    # Federation.run rejects a ckpt_dir that would never be written to
    ckpt_every = args.ckpt_every
    if args.ckpt_dir is not None and ckpt_every is None and not args.resume:
        ckpt_every = args.rounds
    # the run ledger: --metrics-out streams it as JSONL; --trace-out also
    # keeps it in memory for the simulated-time trace after the run
    from repro_torch import obs

    sinks, mem = [], None
    if args.metrics_out and rank == 0:
        sinks.append(obs.make_sink("jsonl", path=args.metrics_out))
    if args.trace_out:
        mem = obs.InMemorySink()
        sinks.append(mem)
    sink = obs.tee(sinks)
    if args.metrics_every is not None and not (args.metrics_out
                                               or args.trace_out):
        raise SystemExit("--metrics-every requires --metrics-out or "
                         "--trace-out")
    with _profiler(args.profile_dir, device):
        gp, hist = fed.run(
            params, cd, generator=gen,
            snapshot_every=(args.snapshot_every if store is not None
                            else None),
            store=store, ckpt_every=ckpt_every, ckpt_dir=args.ckpt_dir,
            resume=args.resume, metrics_every=args.metrics_every, sink=sink)
    if sink is not None:
        sink.close()
    out = {"mode": "fl", "method": args.method, "engine": args.engine,
           "model": args.model, "sketch": args.sketch,
           "regime": args.regime, "scenario": args.scenario, "rho": args.rho,
           "scenario_spearman": round(scn.metadata["spearman"], 4),
           "source": source, "rounds": hist.rounds,
           "strategy_extras": {k: (v.tolist() if torch.is_tensor(v) else v)
                               for k, v in extras.items()},
           "test_acc": hist.test_acc, "train_loss": hist.train_loss,
           "final_assignment": hist.assignments[-1],
           "final_counts": hist.counts[-1],
           "mean_churn": round(float(np.mean(hist.churn)), 4),
           "final_entropy": round(hist.entropy[-1], 4),
           "mean_drift": round(float(np.mean(hist.drift)), 6),
           "wall_s": round(time.time() - t0, 1),
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "local_s": hist.trace.local_s.tolist(),
           "server_s": hist.trace.server_s.tolist(), "history": hist,
           "params": gp, "scenario_metadata": scn.metadata}
    if fed.mesh is not None:
        out["mesh"] = mesh_lib.mesh_spec(fed.mesh)
        out["backend_sharded"] = getattr(
            getattr(fed.strategy, "backend", None), "name", None)
    if args.fleet_size is not None:
        out["fleet_size"] = args.fleet_size
        out["cohort_size"] = args.clients
    if args.metrics_out:
        out["metrics_out"] = args.metrics_out
    if args.profile_dir:
        out["profile_dir"] = args.profile_dir
    if args.trace_out and rank == 0:
        from repro_torch.obs import timeline

        try:
            trace = timeline.write_trace(args.trace_out, mem.records)
        except ValueError as e:
            raise SystemExit(f"--trace-out: {e}") from None
        out["trace_out"] = args.trace_out
        out["trace_events"] = len(trace["traceEvents"])
    if store is not None:
        out["snapshot_dir"] = args.snapshot_dir
        out["published_rounds"] = store.rounds()
    if args.ckpt_dir is not None:
        from repro_torch import checkpoint

        out["ckpt_dir"] = args.ckpt_dir
        out["ckpt_rounds"] = checkpoint.available_steps(args.ckpt_dir)
        out["resumed"] = bool(args.resume)
    if hist.sim_times is not None:      # the IoT-substrate accounting
        out.update({
            "fleet": args.fleet,
            "sim_time_s": round(sum(hist.sim_times), 3),
            "wan_MB": round(sum(hist.wan_bytes) / 1e6, 3),
            "edge_MB": round(sum(hist.edge_bytes) / 1e6, 3),
            "mean_participation": round(
                float(np.mean(hist.participation)), 3)})
    if hist.quarantine is not None:     # the byzantine-attack block
        out.update({
            "attack": args.attack,
            "adv_frac": args.adv_frac,
            "rho_adv": args.rho_adv,
            "n_adversaries": int(np.sum(hist.adversary[-1])),
            # null = diverged run (NaN is not valid RFC 8259 JSON)
            "final_quarantine": _finite(hist.quarantine[-1], 4),
            "final_contamination": _finite(hist.contamination[-1], 6)})
    if args.dp_sigma > 0.0 or np.isfinite(args.dp_clip):   # the DP block
        eps = privacy.gaussian_epsilon(args.dp_sigma, args.rounds)
        out.update({
            "dp_sigma": args.dp_sigma,
            # null = unconstrained (inf is not valid RFC 8259 JSON)
            "dp_clip": args.dp_clip if np.isfinite(args.dp_clip) else None,
            "dp_epsilon": round(eps, 4) if np.isfinite(eps) else None})
    if hist.event_times is not None:    # the event_driven energy ledger
        out.update({
            "energy_budget_j": (args.energy_budget
                                if np.isfinite(args.energy_budget) else None),
            "events": len(hist.event_times),
            "final_sim_time_s": round(hist.event_times[-1], 3),
            "energy_spent_j": round(
                float(np.sum(hist.trace.energy_spent[-1])), 3),
            "devices_exhausted": int(
                np.sum(hist.trace.energy_exhausted[-1]))})
    if rank == 0:
        print(json.dumps({k: v for k, v in out.items()
                          if k not in _UNPRINTED}, indent=1, default=float))
    return out


def run_pretrain(args) -> dict:
    from repro_torch.configs import get, reduced
    from repro_torch.data import synthetic
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf

    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    layers.set_flash_kernel(args.flash)
    cfg = get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = tf.init(torch.Generator(device=device).manual_seed(args.seed),
                    cfg, device=device)
    params = dict(model.named_parameters())
    print(f"pretraining {cfg.name}: "
          f"{sum(p.numel() for p in params.values()):,} params")

    # remat off, as the reference's run_pretrain calls its step
    step_fn, opt = steps_mod.make_train_step(cfg, optimizer=args.optimizer,
                                             lr=args.lr, remat=False)
    opt_state = opt.init(params)
    toks = torch.from_numpy(synthetic.lm_tokens(
        args.batch_size * args.steps, args.seq_len + 1, cfg.vocab,
        seed=args.seed)).to(device)
    losses, step_s = [], []
    t0 = time.time()
    with _profiler(args.profile_dir, device):
        for i in range(args.steps):
            t_step = time.perf_counter()
            batch = {"tokens": toks[i * args.batch_size:
                                    (i + 1) * args.batch_size]}
            # float() synchronises
            losses.append(float(step_fn(model, opt_state, batch)))
            step_s.append(time.perf_counter() - t_step)
            if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
                print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                      f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    out = {"mode": "pretrain", "arch": cfg.name, "losses": losses,
           "loss_first": losses[0], "loss_last": losses[-1],
           "wall_s": round(time.time() - t0, 1),
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "step_s": step_s}
    print(json.dumps({k: v for k, v in out.items() if k != "step_s"},
                     indent=1, default=float))
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"training did not reduce loss: {losses}")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", default="fl", choices=["fl", "pretrain"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; exits "
                         "non-zero without a card unless this is cpu)")
    ap.add_argument("--method", default="coalition",
                    choices=sorted(strategies.available_strategies()))
    ap.add_argument("--regime", default="iid",
                    choices=sorted(partition.available_regimes()))
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--coalitions", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--local-epochs", type=int, default=5)
    ap.add_argument("--n-train", type=int, default=20000)
    ap.add_argument("--n-test", type=int, default=4000)
    ap.add_argument("--backend", default="cuda",
                    choices=sorted(bk.available_backends()),
                    help="coalition-round backend: cuda (the hand-written "
                         "kernels), stream or dot (plain PyTorch)")
    ap.add_argument("--sketch", default="identity",
                    choices=sorted(sketch_mod.available_sketchers()),
                    help="coalition methods: run assignment and medoid "
                         "election on a seeded (N, S) sketch of the client "
                         "weights instead of full (N, D) distances; "
                         "'identity' is the exact path")
    ap.add_argument("--sketch-dim", type=int, default=None,
                    help="sketch dimension S (rproj/countsketch; "
                         "default 256)")
    ap.add_argument("--top-m", type=int, default=None,
                    help="coalition_topk: aggregate only the top_m largest "
                         "coalitions (default K - 1)")
    ap.add_argument("--trim", type=int, default=None,
                    help="fedavg_trimmed: per-coordinate trim count")
    ap.add_argument("--client-weights", default=None,
                    help="comma-separated per-client weights (fedavg_weighted"
                         " / coalition barycenters), e.g. '1,1,2,4'")
    ap.add_argument("--model", default="cnn",
                    choices=sorted(zoo_mod.available_models()))
    ap.add_argument("--engine", default="scan",
                    choices=["scan", "python", "semi_async", "event_driven"],
                    help="scan and python run the same Python round loop; "
                         "semi_async runs it over a simulated device fleet "
                         "with partial participation and staleness-weighted "
                         "merging; event_driven as continuous-time "
                         "completion events under per-device energy "
                         "budgets")
    ap.add_argument("--mesh", default=None,
                    help="run the coalition round split along D over the "
                         "ranks of a mesh: 'host', 'production', or "
                         "explicit 'axis=N' pairs with a 'data' axis (e.g. "
                         "'data=2' under torchrun --nproc-per-node 2; the "
                         "product must equal the world size). Validated "
                         "before any data loads; echoed in the summary")
    ap.add_argument("--chunk", type=int, default=None,
                    help="column tile of the coalition round's streaming "
                         "sweeps (coalition methods; default min(D, "
                         "65536); the cuda kernels sweep in their own "
                         "tiles)")
    ap.add_argument("--fleet-size", type=int, default=None,
                    help="cohort mode: a fleet of this many devices, of "
                         "which an availability-weighted cohort of "
                         "--clients trains each round (--engine scan or "
                         "python)")
    # fl: IoT substrate (engine=semi_async)
    ap.add_argument("--fleet", default="ideal",
                    help="fleet profile name (see "
                         "repro_torch.sim.available_fleets); the sampled "
                         "profiles are the port's own tables")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="global scale on per-device availability")
    ap.add_argument("--staleness", type=float, default=0.5,
                    help="staleness decay exponent alpha in (1+tau)^-alpha")
    ap.add_argument("--deadline", type=float, default=float("inf"),
                    help="round deadline in simulated seconds")
    ap.add_argument("--energy-budget", type=float, default=float("inf"),
                    help="per-device energy budget in joules "
                         "(engine=event_driven; each train/transmit cycle "
                         "depletes it and exhausted devices retire)")
    ap.add_argument("--max-events", type=int, default=None,
                    help="event budget of the event_driven engine "
                         "(default: rounds - 1)")
    ap.add_argument("--sim-seed", type=int, default=0,
                    help="fleet sampling seed")
    # fl: joint fleet+data scenarios (repro_torch.sim.scenarios)
    ap.add_argument("--scenario", default="independent",
                    help="joint fleet+data scenario (see "
                         "repro_torch.sim.available_scenarios): "
                         "'independent', 'correlated-skew' (weak devices "
                         "hold the most label-skewed shards) or "
                         "'correlated-quantity'")
    ap.add_argument("--rho", type=float, default=0.0,
                    help="fleet-data coupling strength in [0, 1]; 0 is "
                         "the independent sampling")
    # fl: adversaries and privacy (repro_torch.sim.attacks, DP client path)
    ap.add_argument("--attack", default=None,
                    choices=sorted(sim_attacks.available_attacks()),
                    help="byzantine attack of the compromised fraction of "
                         "clients; absent = every client honest")
    ap.add_argument("--adv-frac", type=float, default=0.0,
                    help="fraction of the fleet compromised, in [0, 1)")
    ap.add_argument("--rho-adv", type=float, default=0.0,
                    help="adversary placement rank coupling in [-1, 1]: "
                         "+1 the strongest devices, -1 the weakest, 0 "
                         "seeded-random")
    ap.add_argument("--dp-clip", type=float, default=float("inf"),
                    help="per-client L2 clip norm of the update delta "
                         "(inf = no clipping)")
    ap.add_argument("--dp-sigma", type=float, default=0.0,
                    help="Gaussian noise multiplier of the DP client path "
                         "(noise std = dp_sigma * dp_clip); the composed "
                         "epsilon lands in the summary")
    # fl: checkpointing + serving snapshots (the producer half of the
    # train/serve pair; repro_torch.launch.serve --mode fl is the consumer)
    ap.add_argument("--ckpt-dir", default=None,
                    help="write resumable federation checkpoints here")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="checkpoint cadence in rounds (requires "
                         "--ckpt-dir; the final round is always saved; "
                         "default with --ckpt-dir: round 0 + final only)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint under --ckpt-dir "
                         "and continue to the uninterrupted run's history")
    ap.add_argument("--snapshot-dir", default=None,
                    help="publish serving snapshots (theta + coalition "
                         "barycenters + routing assignment) into this "
                         "model store directory")
    ap.add_argument("--snapshot-every", type=int, default=1,
                    help="publish cadence in rounds (with --snapshot-dir)")
    ap.add_argument("--snapshot-keep", type=int, default=None,
                    help="retain only the newest N snapshots")
    # fl: observability (repro_torch.obs)
    ap.add_argument("--metrics-out", default=None,
                    help="stream the per-round run ledger to this JSONL "
                         "file while training; tail it live")
    ap.add_argument("--metrics-every", type=int, default=None,
                    help="ledger cadence in rounds (default 1; round 0 and "
                         "the final round always emit)")
    ap.add_argument("--trace-out", default=None,
                    help="write a simulated-time Chrome trace-event JSON "
                         "(open in https://ui.perfetto.dev); needs "
                         "--engine semi_async or event_driven")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace of the run "
                         "here (real hardware time, vs. the simulated-time "
                         "--trace-out)")
    # pretrain
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--optimizer", default="adam",
                    help="adam, or SGD with momentum 0.9 for any other name")
    ap.add_argument("--flash", action="store_true",
                    help="route attention through the hand-written flash "
                         "kernel")
    # shared
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the summary JSON to this file")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    out = run_fl(args) if args.mode == "fl" else run_pretrain(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({k: v for k, v in out.items() if k not in _UNPRINTED},
                      f, default=float)
    return out


if __name__ == "__main__":
    main()
