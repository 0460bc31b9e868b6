"""Federated training driver (``--mode fl``) of the PyTorch port.

The paper's experiment: federated training of the MNIST-surrogate CNN with
coalition aggregation (Algorithm 1).  It prints the reference's JSON
summary keys plus ``device``.

The run is on a CUDA card unless the caller passes ``--device cpu``; without
a card and without ``--device cpu`` it exits non-zero.  The f32 CNN runs
with TF32 off (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` both False) so it matches the f32
reference.  ``--backend cuda`` (the default) runs the fused round's two
hand-written kernels; ``stream`` and ``dot`` run it in plain PyTorch.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl --rounds 3
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl --device cpu \
      --regime shard --rounds 3 --clients 6 --coalitions 2 --local-epochs 1 \
      --n-train 600 --n-test 200
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import backends as bk
from repro_torch.core import strategies
from repro_torch.data import partition
from repro_torch.models import zoo as zoo_mod


def resolve_device(name: str) -> torch.device:
    """The run's device; a CUDA device must exist, there is no fallback."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to "
                         "run on the CPU")
    return device


def run_fl(args) -> dict:
    from repro_torch import sim
    from repro_torch.core.client import ClientConfig
    from repro_torch.core.server import Federation, FederationConfig
    from repro_torch.data import loader, synthetic

    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    data = synthetic.mnist_idx()
    source = "mnist-idx"
    if data is None:
        data = (synthetic.digits(args.n_train, seed=0),
                synthetic.digits(args.n_test, seed=1))
        source = "synthetic-digits"
    (xtr, ytr), (xte, yte) = data
    scn = sim.make_scenario("independent", ytr, args.clients,
                            regime=args.regime, seed=args.seed)
    cd = {k: torch.from_numpy(v).to(device) for k, v in
          loader.client_datasets(xtr, ytr, scn.index_matrix).items()}
    xte_t = torch.from_numpy(xte).to(device)
    yte_t = torch.from_numpy(yte).to(device)

    cfg = FederationConfig(
        n_clients=args.clients, n_coalitions=args.coalitions,
        rounds=args.rounds, method=args.method,
        client=ClientConfig(epochs=args.local_epochs,
                            batch_size=args.batch_size, lr=args.lr),
        backend=args.backend, engine=args.engine)
    model = zoo_mod.make_model(args.model)
    # one CPU generator per run: the CNN init, then the federation's draws
    gen = torch.Generator().manual_seed(args.seed)
    params = model.init(gen, device=device)
    t0 = time.time()
    fed = Federation(model, lambda p: model.accuracy(p, xte_t, yte_t), cfg)
    _, hist = fed.run(params, cd, generator=gen)
    out = {"mode": "fl", "method": args.method, "engine": args.engine,
           "model": args.model, "sketch": "identity",
           "regime": args.regime, "scenario": "independent", "rho": 0.0,
           "scenario_spearman": round(scn.metadata["spearman"], 4),
           "source": source, "rounds": hist.rounds,
           "strategy_extras": {},
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
           "server_s": hist.trace.server_s.tolist()}
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("rounds", "local_s", "server_s")},
                     indent=1, default=float))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", default="fl", choices=["fl"],
                    help="fl: federated training (pretrain waits for ROADMAP "
                         "queue A item 11)")
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
                    help="fused-round backend: cuda (the hand-written "
                         "kernels), stream or dot (plain PyTorch)")
    ap.add_argument("--model", default="cnn",
                    choices=sorted(zoo_mod.available_models()))
    ap.add_argument("--engine", default="scan", choices=["scan", "python"],
                    help="both run the same Python round loop in PyTorch")
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> dict:
    return run_fl(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
