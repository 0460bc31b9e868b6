#!/usr/bin/env python3
"""Is the FL local phase bit-reproducible on the card, and what would
``torch.use_deterministic_algorithms`` cost?

    python3 scripts/determinism_cost.py

Runs the main path's local phase (the paper CNN, 10 clients of 2,000
synthetic digits, 5 epochs at batch 10, f32 with TF32 off) from the same
weights and batch order REPS times in each of two processes: torch's
defaults, and deterministic mode (``torch.use_deterministic_algorithms
(True)``, ``cudnn.deterministic``, ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set
before CUDA starts).  Prints, per mode, each phase's seconds (host clock
ended by a synchronise; the first includes cuDNN's warm-up), whether every
repeat's (N, D) client matrix equals the first bit for bit, the largest
difference over the max otherwise, and a hash of the matrix, so the two
modes can be compared.  Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 3


def phase(deterministic: bool) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import client, pytree
    from repro_torch.data import loader, partition, synthetic
    from repro_torch.models import zoo

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if deterministic:
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
    model = zoo.make_model("cnn")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device="cuda")
    x, y = synthetic.digits(20_000, seed=0)
    cd = {k: torch.from_numpy(v).cuda() for k, v in loader.client_datasets(
        x, y, partition.partition("iid", y, 10, seed=0)).items()}
    perms = torch.argsort(torch.rand((10, 5, cd["y"].shape[1]),
                                     generator=gen), dim=-1).cuda()
    cfg = client.ClientConfig(epochs=5, batch_size=10, lr=0.01)
    seconds, mats = [], []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stacked, _ = client.local_phase(model.loss_fn, params, cd, perms,
                                        cfg)
        w = pytree.client_matrix(stacked, model.layout)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        mats.append(w.cpu().numpy())
    diffs = [float(np.abs(m - mats[0]).max() / np.abs(mats[0]).max())
             for m in mats[1:]]
    return {"deterministic": deterministic, "seconds": seconds,
            "bitwise": all(np.array_equal(m, mats[0]) for m in mats[1:]),
            "max_rel_diff": max(diffs),
            "sha": hashlib.sha256(mats[0].tobytes()).hexdigest()[:16]}


def main() -> int:
    if len(sys.argv) > 1:                     # one mode, in its own process
        print(json.dumps(phase(sys.argv[1] == "deterministic")))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("determinism_cost: no CUDA device is available",
              file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for mode in ("default", "deterministic"):
        env = dict(os.environ)
        if mode == "deterministic":
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        proc = subprocess.run([sys.executable, __file__, mode], env=env,
                              capture_output=True, text=True)
        if proc.returncode:
            print(f"{mode}: failed\n{proc.stderr[-3000:]}")
            continue
        print(f"{mode}: {proc.stdout.strip().splitlines()[-1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
