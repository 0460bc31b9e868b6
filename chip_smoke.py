#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

In order, it
  1. prints the card (``nvidia-smi`` name and power limit) and the torch and
     nvcc versions;
  2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
     and prints the build time and the ptxas report;
  3. holds each kernel against its plain PyTorch version on the card at the
     main path's shape (N = 10, K = 3, D = 582,026, f32), at a ragged shape
     with larger N and K, and at a small bf16 shape: the max error must stay
     within 5e-6 of the max for both dtypes (kernel and plain version upcast
     the same bf16 values to f32), and the launch counters must move; the whole fused round on the ``cuda`` backend is held
     against the ``stream`` backend too;
  4. times each kernel at the main path's shape with CUDA events after a
     warm-up, with the 50 MB L2 cache flushed before every launch, beside
     its bound, its plain version and (pass 1) ``torch.cdist``, and the
     host time a wrapper call takes to enqueue;
  5. runs ``repro_torch.launch.train --mode fl`` at its defaults with
     ``--rounds 3`` on the card, with the launch counters set to 0 just
     before: each kernel must have launched once per server step (= rounds),
     and the final test accuracy must be finite and above chance (0.1);
  6. traces one round of the main path's shape with torch.profiler and
     prints the device's busy share and its top kernels;
  7. prints the card again, one JSON line with every kernel's numbers, and
     last ``{"ok": true, "device": {...}}``.

Any failure exits non-zero.  Without a CUDA device it exits 1 before any
result.  It imports nothing of JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: main-path shape: the paper CNN's D, 10 clients, 3 coalitions
MAIN = (10, 3, 582_026)
#: the other shapes the kernels are held to: (N, K, D, dtype name)
CHECKS = ((10, 3, 582_026, "float32"), (64, 8, 1_000_003, "float32"),
          (16, 4, 70_001, "bfloat16"))
#: kernel vs plain version, max abs error / max |plain|: both compute in f32
#: from the same inputs, so bf16 W is held to the f32 bound too
TOL = 5e-6
ROUNDS = 3
#: H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
#: fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
REPLACES = {"center_sq_dists": "src/repro/kernels/fused_round.py:52",
            "fused_coalition_stats": "src/repro/kernels/fused_round.py:100"}
SOURCE = "src/repro_torch/kernels/csrc/fused_round.cu"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def inputs(n: int, k: int, d: int, dtype, seed: int = 0):
    """W (N, D), the (K, N) center one-hot and a (K, N) aggregation matrix."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((n, d), generator=g, device="cuda").to(dtype)
    centers = torch.randperm(n, generator=g, device="cuda")[:k]
    conehot = torch.nn.functional.one_hot(centers, n).float()
    assign = torch.randint(0, k, (n,), generator=g, device="cuda")
    m = torch.nn.functional.one_hot(assign, k).T.float()
    m = (m / torch.clamp(m.sum(1, keepdim=True), min=1.0)).contiguous()
    return w, conehot, m


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / (float(want.abs().max()) + 1e-12)


def check_kernels() -> dict:
    """Phase 3: every kernel against its plain version; returns main-shape
    max abs errors."""
    import torch

    from repro_torch.kernels import fused_round as fr
    from repro_torch.kernels import ref

    errs = {}
    for n, k, d, dname in CHECKS:
        dtype = getattr(torch, dname)
        w, conehot, m = inputs(n, k, d, dtype)
        before = dict(fr.LAUNCHES)
        got = fr.center_sq_dists(w, conehot)
        b, theta, med = fr.fused_coalition_stats(w, m)
        torch.cuda.synchronize()
        want = ref.center_sq_dists(w, conehot)
        b_ref, theta_ref, med_ref = ref.fused_coalition_stats(w, m)
        res = {"center_sq_dists": [rel_err(got, want)],
               "fused_coalition_stats": [rel_err(b, b_ref),
                                         rel_err(theta, theta_ref),
                                         rel_err(med, med_ref)]}
        for name, pairs in res.items():
            worst_abs = max(a for a, _ in pairs)
            worst_rel = max(r for _, r in pairs)
            moved = fr.LAUNCHES[name] - before[name]
            print(f"check {name} N={n} K={k} D={d} {dname}: max abs err "
                  f"{worst_abs:.3e}, / max {worst_rel:.3e} (bound "
                  f"{TOL:.0e}), launches +{moved}")
            if not worst_rel <= TOL:
                fail(f"{name} disagrees with its plain version at N={n} "
                     f"K={k} D={d} {dname}")
            if moved != 1:
                fail(f"{name}'s launch counter moved by {moved}, not 1")
            if (n, k, d) == MAIN and dname == "float32":
                errs[name] = worst_abs
        del w, b, theta, med, b_ref, theta_ref, med_ref
    return errs


def check_round() -> None:
    """The whole fused round on the cuda backend against the stream one."""
    import torch

    from repro_torch.core import coalitions

    n, k, d = MAIN
    w, _, _ = inputs(n, k, d, torch.float32, seed=1)
    w += 5.0 * (torch.arange(n, device="cuda") % k)[:, None]  # separated
    state = coalitions.init_centers(w, k, perm=torch.arange(n))
    rc = coalitions.run_round(w, state, backend="cuda")
    rs = coalitions.run_round(w, state, backend="stream")
    same = (torch.equal(rc.assignment, rs.assignment)
            and torch.equal(rc.new_center_idx, rs.new_center_idx))
    _, theta_err = rel_err(rc.theta, rs.theta)
    print(f"round cuda vs stream: assignment and centers equal: {same}, "
          f"theta err / max {theta_err:.3e}")
    if not same or not theta_err <= TOL * 10:
        fail("the cuda backend's round disagrees with the stream backend's")


def time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median ms of ``fn`` on the card, by CUDA events around each call,
    with the 50 MB L2 cache flushed before each.  The flush writes 1 GiB
    (~0.3 ms of device time), so the card is still busy with it while the
    host enqueues the call: the events time the device, not the host."""
    import torch

    buf = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def host_us(fn, reps: int = 200) -> float:
    """Mean host microseconds to enqueue one call of ``fn``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def time_kernels() -> dict:
    """Phase 4: kernel, plain and library times with bounds, main shape."""
    import torch

    from repro_torch.kernels import fused_round as fr
    from repro_torch.kernels import ref

    n, k, d = MAIN
    w, conehot, m = inputs(n, k, d, torch.float32)
    centers = (conehot @ w).contiguous()
    wb = n * d * 4
    calls = {
        "center_sq_dists": (lambda: fr.center_sq_dists(w, conehot),
                            lambda: ref.center_sq_dists(w, conehot),
                            lambda: torch.cdist(w, centers)),
        "fused_coalition_stats": (lambda: fr.fused_coalition_stats(w, m),
                                  lambda: ref.fused_coalition_stats(w, m),
                                  None)}
    sizes = {
        "center_sq_dists": (wb + 4 * (k * n + n * k),
                            2 * k * n * d + 3 * n * k * d),
        "fused_coalition_stats": (wb + 4 * (k * n + k * d + d + n * k),
                                  2 * k * n * d + k * d + d + 3 * n * k * d)}
    out = {}
    for name, (kernel, plain, library) in calls.items():
        nbytes, ops = sizes[name]
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = ops / PEAK_FP32 * 1e3
        row = {"ms": time_ms(kernel), "plain_ms": time_ms(plain),
               "library_ms": None if library is None else time_ms(library),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        enqueue = host_us(kernel)
        lib = row["library_ms"]
        print(f"time {name} N={n} K={k} D={d} f32, L2 flushed: kernel "
              f"{row['ms']:.4f} ms ({nbytes / row['ms'] / 1e6:.1f} GB/s), "
              f"plain {row['plain_ms']:.4f} ms, library "
              f"{'-' if lib is None else f'{lib:.4f}'} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); wrapper host "
              f"time {enqueue:.1f} us")
        out[name] = row
    return out


def run_main_path() -> dict:
    """Phase 5: the port's training entry point, counters reset just before."""
    from repro_torch.kernels import fused_round as fr
    from repro_torch.launch import train

    fr.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main(["--mode", "fl", "--rounds", str(ROUNDS)])
    wall = time.perf_counter() - t0
    launches = dict(fr.LAUNCHES)
    for r, (loc, srv) in enumerate(zip(out["local_s"], out["server_s"])):
        print(f"round {r}: local phase {loc:.4f} s, server step {srv:.4f} s")
    print(f"train --mode fl --rounds {ROUNDS}: {wall:.1f} s, launches "
          f"{launches}, test_acc {out['test_acc']}")
    for name, count in launches.items():
        if count != ROUNDS:
            fail(f"{name} launched {count} times in {ROUNDS} server steps")
    acc = out["test_acc"][-1]
    if not (math.isfinite(acc) and acc > 0.1):
        fail(f"final test accuracy {acc} is not above chance")
    if len(out["test_acc"]) != ROUNDS:
        fail(f"expected {ROUNDS} rounds, got {len(out['test_acc'])}")
    return launches


def profile_round() -> None:
    """Phase 6: where a round's time goes on the device.  One round of the
    main path's shape (10 clients, 20 vmapped SGD steps of batch 10, then
    the fused server step on the cuda backend), timed plain and then traced
    with torch.profiler: the device's busy share and its top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import client, coalitions, pytree
    from repro_torch.models import cnn

    n, k, _ = MAIN
    steps, bs = 20, 10
    g = torch.Generator().manual_seed(0)
    params = cnn.init(g, device="cuda")
    data = {"x": torch.rand((n, steps * bs, 28, 28, 1), generator=g).cuda(),
            "y": torch.randint(0, 10, (n, steps * bs), generator=g).cuda()}
    perms = torch.argsort(torch.rand((n, 1, steps * bs), generator=g),
                          dim=-1).cuda()
    state = coalitions.CoalitionState(
        center_idx=torch.arange(k, device="cuda"), round=0)

    def one_round():
        stacked, _ = client.local_phase(cnn.loss_fn, params, data, perms,
                                        client.ClientConfig(epochs=1))
        w = pytree.client_matrix(stacked, cnn.REF_LAYOUT)
        coalitions.run_round(w, state, backend="cuda")
        torch.cuda.synchronize()

    one_round()                                      # warm-up
    t0 = time.perf_counter()
    one_round()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_round()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"profile: one round of {steps} steps: {wall:.4f} s, device busy "
          f"{busy:.4f} s ({100 * busy / wall:.1f}% of the round), "
          f"{steps} steps at {1e3 * wall / steps:.2f} ms each")
    for e in kernels[:6] + [e for e in kernels[6:] if "sq_dists" in e.key]:
        print(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:5d}x  {e.key[:70]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    print(card_line())
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"{nvcc.stdout.strip().splitlines()[-1]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    print(build.ptxas_report().strip())

    errs = check_kernels()
    check_round()
    times = time_kernels()
    launches = run_main_path()
    profile_round()

    kernels = []
    for name in ("center_sq_dists", "fused_coalition_stats"):
        row = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
