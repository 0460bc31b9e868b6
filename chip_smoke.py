#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

In order, it
  1. prints the card (``nvidia-smi`` name and power limit) and the torch and
     nvcc versions;
  2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, each its own library, all started together) and prints the
     build time, the ptxas report and, from ``cudaFuncGetAttributes``, each
     ``flash_attention`` kernel's registers a thread, shared memory a CTA and
     local memory (spills) a thread, and the registers and local memory of
     every route of the fused round, ``sq_dists_to_points``,
     ``pairwise_sq_dists`` and ``segment_sum``, and of the CNN block's two
     kernels (any spill fails);
  3. holds each kernel against its plain PyTorch version on the card: the
     fused-round kernels at the main path's shape (N = 10, K = 3,
     D = 582,026, f32, and in bf16), at a ragged shape with larger N and K,
     at a small bf16 shape and at D = 8,000,000, each with the route it
     took; the distance and segment-sum kernels at those shapes (with their
     routes) and at the sketch widths D = S in {1, 64, 255, 256, 1024, 2048}
     (f32, and bf16 at 256), ``pairwise_sq_dists`` (its route from
     ``pairwise_route``) symmetric bit for bit, with its diagonal exactly 0
     and a repeat equal bit for bit.  The max error must stay within 5e-6 of
     the max for both dtypes (kernel and plain version upcast the same bf16
     values to f32), and the launch counters must move.
     ``fused_coalition_stats`` also at the main shape (f32, bf16) with an
     aggregation matrix of fractional masses: the ``semi_async`` engine's
     staleness weights ``(1 + tau)^-0.5``, tau in 0..4, normalised per
     coalition as ``aggregation_matrix`` does (phase c).  ``flash_attention``
     at the reference's sweep in f32 and bf16, at the pretrain path's and
     the serve path's shapes (the seamless encoder's (4, 16, 16, 960, 960,
     64), non-causal) and at ragged, longer and wider (Dh 96, 128) shapes
     in bf16, within the
     reference's rtol = atol (2e-4 f32, 2e-2 bf16), and its gradient
     through ``ops.flash_attention`` within 2e-3 of the plain version's;
  4. holds whole rounds on the ``cuda`` backend against the ``stream``
     backend at the main width: the fused round, the composed round and the
     sketched round (rproj and countsketch, S = 256), each with the launch
     counters set to 0 just before: equal assignments and centers, θ within
     5e-6 of its max, and the launches of each with their routes; and the
     fused and countsketch rounds again under staleness client weights with
     one client at weight 0, which must not be elected (phase d);
  5. times each kernel at the main path's shapes with CUDA events after a
     warm-up, with the 50 MB L2 cache flushed before every launch, beside
     its bound, its plain version and a one-call library yardstick, and the
     host time a wrapper call takes to enqueue; the five memory-bound
     kernels and ``w.sum()`` also with a clean L2 (the flush's dirty lines
     written back before the launch), and the fixed cost of one step of
     the register sweep with and without its last-CTA sum
     (``flash_attention`` in bf16
     at the pretrain path's and the serve path's shapes, against
     ``F.scaled_dot_product_attention``, and at S = 4096 with window 1024,
     each with the wrapper's host time beside the kernel's device time);
  5a. the CNN's first block (``kernels/conv_pool.py``): its forward and
     weight-gradient kernels at the local phase's vmapped step (C = 100
     clients x B = 50 images) and the evaluation's call (1 x 10,000),
     against the plain versions (the forward within 5e-6 of the max and
     its argmax equal wherever the window's two largest values part by
     more than 1e-5 of the max; the weight gradient within
     5e-6 x sqrt(B / 50)) and timed beside their bounds (max of operations
     over 67 TFLOP/s and bytes over 3.35 TB/s), the plain versions and
     ATen's grouped ``F.conv2d`` + ReLU + ``max_pool2d`` and its autograd
     backward to the weights as the library yardstick (timed only);
  6. runs ``repro_torch.launch.train --mode fl`` at its defaults with
     ``--rounds 3`` on the card, with the launch counters set to 0 just
     before: each fused-round kernel must have launched once per server step
     (= rounds), the CNN block's weight gradient once a vmapped SGD step
     (rounds x epochs x batches a client, from the entry point's defaults)
     and its forward once a step and once an evaluation (one a round), no other
     kernel at all, and the final test accuracy must be finite and above
     chance (0.1); the other training phases below count the CNN block's
     kernels without holding them;
  6a. runs FedAvg, the paper's baseline, on the ``semi_async`` engine over
     the ``ideal`` fleet (``train --mode fl --method fedavg --engine
     semi_async --rounds 3``), counters set to 0 just before: no kernel
     launches, accuracy finite and above chance, full participation,
     ``wan_MB`` = 3 rounds x 10 clients x 2 x the CNN's 2,328,104 bytes
     (139.686) and ``edge_MB`` 0 (phase a);
  6b. runs Algorithm 1 on the ``semi_async`` engine over the
     ``cellular-flaky`` fleet (``train --mode fl --engine semi_async --fleet
     cellular-flaky --rounds 3``), counters set to 0 just before: each
     fused-round kernel once a round and nothing else; per round WAN bytes
     = min(K, present) x 2 x model bytes and edge bytes = present x 2 x
     model bytes; fails if every round had full participation (phase b);
  6c. runs Algorithm 1 on the ``event_driven`` engine over
     ``cellular-flaky`` (``train --mode fl --engine event_driven --fleet
     cellular-flaky --max-events 4 --energy-budget B``), B the dearest
     device's cycle joules in the port's table at sim-seed 0, counters set
     to 0 just before: each fused-round kernel 5 times (census + 4 events)
     and nothing else; event times never decrease; every device's spend a
     whole number of its cycle's joules within 1e-5 and within B; some
     device retired and some alive; θ and accuracy finite (phase e);
  6d. runs the reference's coupled-scenario example cut to 3 rounds
     (``--engine semi_async --fleet cellular-flaky --scenario
     correlated-skew --regime dirichlet --rho 1.0``), counters set to 0
     just before: each fused-round kernel 3 times; the run's spearman and
     permutation equal ``make_scenario``'s on the host (phase f);
  6e. runs cohort mode over 1,048,576 devices (``--fleet cellular-flaky
     --fleet-size 1048576 --rounds 3``), counters set to 0 just before:
     each fused-round kernel 3 times; every cohort distinct devices of
     positive availability; then times the schedule's sampling on the card
     and holds ``sample_cohort`` at N = 1,048,576 on the card to the CPU
     and to flat top-k from the same Gumbel row (phase g);
  6f. runs ``--attack sign_flip --adv-frac 0.2 --rounds 3``, counters set
     to 0 just before: each fused-round kernel 3 times; the adversaries
     (2) are ``adversary_mask``'s; quarantine in [0, 1], contamination
     finite and >= 0; then one local phase on the card through the DP path
     at clip 1.0: delta norms within the clip at sigma 0, the noise
     residual's std within 2% of 0.5 at sigma 0.5 (phase h);
  6g. runs the host side (``train --mode fl --engine semi_async --rounds 3
     --snapshot-dir S --snapshot-every 1 --snapshot-keep 2 --ckpt-dir C
     --ckpt-every 1 --metrics-out L --trace-out T``; the ideal fleet, equal
     to scan bit for bit, since the simulated-time trace needs a substrate
     engine), counters set to 0 just before: each fused-round kernel 3
     times and nothing else; the store keeps rounds 1 and 2, the
     checkpoints are rounds 0-2, the ledger is run_meta plus 3 round
     records and its trace validates; prints each snapshot's and
     checkpoint's write time and bytes.  Then, in a process of its own
     under torch's deterministic algorithms (by default the card's local
     phase is not bit-reproducible), the same run at 1 local epoch
     checkpointed every round, cut back to its round-1 checkpoint and
     resumed
     (``--resume``), counters set to 0 just before: each fused kernel
     once; the resume's and the restore's seconds; θ and every trace row
     equal to the uninterrupted run's bit for bit (phase i);
  6h. runs ``serve --mode fl`` on that store at the CLI's defaults,
     counters set to 0 just before (no kernel), with a round published
     after its first batch: a hot swap and one graph capture in all;
     prints queries per second and ``swap_ms_mean``, also at batch 32 over
     64 batches; the routed logits of every client and a stranger within
     1e-5 of the max of a direct forward through that row's model (phase
     ii);
  6i. runs ``train --mode fl --model transformer_tiny --rounds 3
     --local-epochs 1``,
     counters set to 0 just before: each fused kernel 3 times on the bf16
     (10, 27,626) W (its route printed), accuracy finite, the last round
     on ``cuda`` against ``stream`` on the same W and state (equal
     assignment and centers, θ within 5e-6); then both fused kernels at
     that shape against their plain versions, and timed (phase iii);
  7. runs the sketch path, ``train --mode fl --method coalition_topk
     --sketch rproj --sketch-dim 256`` at its defaults for 2 rounds, counters
     set to 0 just before: ``sq_dists_to_points`` twice and ``segment_sum``
     once per server step, the fused-round kernels never, accuracy > 0.1;
     then ``distance.pairwise_sq_dists(W, backend="cuda")`` on that run's
     last client matrix, counters set to 0 just before (its launches
     recorded by route and D), held to its plain version;
  8. the framework-scale phase (N = 10, K = 3, D = 8,000,000 f32, three
     clusters): the exact geometry, as two full-W ``sq_dists_to_points``
     (the gather of the centers timed apart) and as the fused round's two
     passes (and the whole fused round), against
     countsketch + ``sketch_stage`` at S in
     {64, 256, 1024}, timed with CUDA events, with the agreement of the
     assignments (at least 0.95 at S = 1024) and the sketched round's W
     passes (2); the composed round at this D, counters set to 0 just
     before (two ``sq_dists_to_points`` and one ``segment_sum``, its
     assignment equal to the exact geometry's); both fused-round kernels,
     ``sq_dists_to_points`` and the segment sum timed at this D beside their
     bounds (``torch.cdist`` as the distances' yardstick);
     ``distance.pairwise_sq_dists(W, backend="cuda")`` at this D, counters
     set to 0 just before, held to its plain version, and the kernel timed
     beside its bound and ``torch.cdist(w, w)**2``; the sketch builds
     timed at this D and at the main path's;
  6j. the sharded federation at world 1 (phase j), counters set to 0 just
     before each run: ``train --mode fl --mesh data=1 --rounds 3`` at the
     defaults (each fused kernel once a round, nothing else;
     ``backend_sharded`` cuda@data1; accuracy above chance; its server
     step beside the main path's), the one-rank sharded round on seeded W
     at the main shape in f32 and bf16 equal to the dense cuda round bit
     for bit, and ``--method coalition_topk --sketch rproj --sketch-dim 256
     --mesh data=1 --rounds 2`` (``segment_sum`` once a round, nothing
     else);
  6k. 2 gloo ranks sharing the card, spawned by the script (phase k), run
     the sharded cuda round on seeded W at (10, 582,026) and (10,
     8,000,000): each rank's launches 1 + 1 on its contiguous odd-width
     tile; assignments and centers equal to the dense cuda round's, θ,
     barycenters and medoid distances within 5e-6 of max; the ranks' (10,
     3) all-reduce and θ all-gather times; then in this process each
     rank's two kernels on its tile timed beside their bounds, and the
     tile copy;
  9. traces one round of the main path's shape with torch.profiler and
     prints the device's busy share and its top kernels;
  10. runs the pretrain path, ``train --mode pretrain --flash --lr 1e-3
      --steps 8`` at its other defaults (hymba-1.5b in full, batch 10 x 129
      tokens, Adam), counters set to 0 just before: ``flash_attention`` once
      per layer per step (32 x 8), no other kernel, every loss finite and
      the last below the first; prints seconds per step, tokens/s and the
      peak memory.  Then one forward of the full model with the kernel and
      without (losses within 1e-2 relative), and one pretrain step traced
      with torch.profiler (busy share, top kernels);
  10m. hymba-1.5b in full, 3 Adam steps at lr 1e-3 through the flash
      kernel with ``make_train_step(remat=True)`` and again with remat off,
      from the same init and batches (phase m): the first loss equal, the
      later ones within 1e-6 relative (remat changes no arithmetic); s/step, peak memory and flash
      launches a step for both (2L with remat: each block's forward runs
      again in the backward; L without);
  10l. one moonshot-v1-16b-a3b MoE layer at full width (64 experts, top 6,
      d 2048, ff 1408) in f32 on 4 x 32 tokens (phase l): ``moe_apply_ep``
      on a one-rank (data=1, model=1) mesh against ``moe_apply``, both drop
      counts printed at the config's capacity and the outputs within 2e-4
      at capacity 8.0 (no drop on either); its gradients finite;
  10a. runs five serve phases, ``repro_torch.launch.serve --mode lm
      --full --arch A`` at the CLI's other defaults (batch 4, prompt 32, 16
      new tokens, greedy), one full-width bf16 model at a time, freed
      before the next: falcon-mamba-7b (the SSM state), hymba-1.5b (KV
      cache and SSM state), seamless-m4t-large-v2 with ``--flash`` (the
      encoder through the kernel, non-causal; cross-attention on the
      cached memory), phi-3-vision-4.2b (the 576-token modal prefix in the
      cache) and moonshot-v1-16b-a3b (64 experts, top-6), each with the
      counters set to 0 just before: prints the card, ``prefill_s``,
      ``decode_s_per_tok``, the peak memory, the launches, the first
      tokens and a decode step's byte bound, and traces 4 decode steps
      with torch.profiler (busy share, kernels a token); gates (a) tokens
      in the vocabulary and every logit finite, (b) ``flash_attention``
      once per encoder layer in the seamless phase (24) and never in the
      others, (c) prefill S - 1 + one decode step against the full
      forward's last logits (MoE at capacity 8.0), (d) the seamless
      encoder memory and prefill logits through the kernel against the
      plain attention's; (c) and (d) within 5e-2 of max in bf16 as served
      (beside them the forward run a row at a time, and the library's
      SDPA in the kernel's place) and within 1e-4 with the same weights
      cast to f32 and an f32 cache (moonshot: its leading layers that fit
      in 40 GiB of f32);
  10n. the dry-run on the card (phase n, after the serve phases, under
      120 s): ``python -m repro_torch.launch.dryrun --arch chatglm3-6b
      --shape decode_32k --mesh both``, ``--fl``, ``--arch falcon-mamba-7b
      --shape train_4k`` and ``--arch hymba-1.5b --shape prefill_32k`` as
      subprocesses on fake CUDA tensors (``2 ok``, the FL line, ``1 ok``
      each, every record line with its three terms printed; the SSM
      scan is one operator, ``repro_torch::ssm_scan``), and, in a process
      of their own beside the real runs, traces at world 1 (a fake group
      of one, mesh data=1, model=1) of hymba-1.5b's Adam step at phase m's
      batch with remat off and of the paper-CNN FL round at N = 256 on
      ``stream``;
      each step then runs for real on the card under the same counting
      mode: traced FLOPs and bytes within 1% of the real run's, the traced
      peak within 10% of ``max_memory_allocated`` (both over the bytes held
      at the step's start); prints the three roofline terms beside the
      step's time in a run without the counting mode; and the counter's
      own check on the card's torch: on a (4, 4) fake mesh a toy MLP that
      splits evenly counts 1/16 of its unsharded FLOPs a rank;
  11. prints the card again, one JSON line with every kernel's numbers (a
      line for each kernel at the shape its path gives it, and
      ``sq_dists_to_points``, ``segment_sum`` and ``pairwise_sq_dists``
      also at D = 8M, ``sq_dists_to_points`` also at full width; each
      line's launches are those of the path that gives the kernel that
      shape, at the line's route and D: the main path, the sketch path, the
      composed round at the main width and at 8M, the pairwise calls at
      the main width and at 8M, the pretrain path, and ``flash_attention``
      also at the serve path's encoder shape with the seamless phase's
      launches, and the fused round's two kernels also at the
      transformer_tiny path's bf16 (10, 3, 27,626) with its launches, and
      at rank 1's (10, 3, 291,013) tile with phase k's launches there, and
      the CNN block's two kernels at phase 5a's shapes with the main path's
      launches; a line with none fails),
      and last
      ``{"ok": true, "device": {...}}``.

Any failure exits non-zero.  Without a CUDA device it exits 1 before any
result.  It imports nothing of JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: main-path shape: the paper CNN's D, 10 clients, 3 coalitions
MAIN = (10, 3, 582_026)
#: the other shapes the kernels are held to: (N, K, D, dtype name)
CHECKS = ((10, 3, 582_026, "float32"), (64, 8, 1_000_003, "float32"),
          (16, 4, 70_001, "bfloat16"), (10, 3, 8_000_000, "float32"),
          (10, 3, 582_026, "bfloat16"))
#: kernel vs plain version, max abs error / max |plain|: both compute in f32
#: from the same inputs, so bf16 W is held to the f32 bound too
TOL = 5e-6
ROUNDS = 3
#: the IoT-substrate paths: FedAvg on the ideal fleet (phase a) and
#: Algorithm 1 over stragglers (phase b), each for ROUNDS rounds
FEDAVG_ARGS = ["--mode", "fl", "--method", "fedavg", "--engine",
               "semi_async", "--rounds", str(ROUNDS)]
STRAGGLER_ARGS = ["--mode", "fl", "--engine", "semi_async", "--fleet",
                  "cellular-flaky", "--rounds", str(ROUNDS)]
#: the rest of the simulation tier: event_driven under an energy budget
#: (phase e, census + EVENTS events), a coupled scenario (phase f, the
#: reference's own example cut from 20 rounds to ROUNDS), cohort mode over
#: the largest fleet of the reference's BENCH_scale.json sweep (phase g) and
#: a byzantine attack (phase h)
EVENTS = 4
EVENT_ARGS = ["--mode", "fl", "--engine", "event_driven", "--fleet",
              "cellular-flaky", "--max-events", str(EVENTS)]
COUPLED_ARGS = ["--mode", "fl", "--engine", "semi_async", "--fleet",
                "cellular-flaky", "--scenario", "correlated-skew",
                "--regime", "dirichlet", "--rho", "1.0", "--rounds",
                str(ROUNDS)]
FLEET_SIZE = 1_048_576
COHORT_ARGS = ["--mode", "fl", "--fleet", "cellular-flaky", "--fleet-size",
               str(FLEET_SIZE), "--rounds", str(ROUNDS)]
ATTACK_ARGS = ["--mode", "fl", "--attack", "sign_flip", "--adv-frac", "0.2",
               "--rounds", str(ROUNDS)]
#: the host side (phase i): the main path with a snapshot and a checkpoint
#: every round, the newest HOST_KEEP snapshots kept, and the run ledger
#: with its simulated-time trace, which needs a substrate engine: so on
#: semi_async over the ideal fleet, which equals scan bit for bit
HOST_KEEP = 2
HOST_FLAGS = ["--mode", "fl", "--engine", "semi_async", "--rounds",
              str(ROUNDS)]
#: the resume check runs as ``chip_smoke.py RESUME_CHECK DIR``, a process
#: of its own, under torch's deterministic algorithms, whose cuBLAS check
#: needs this workspace setting before CUDA starts
RESUME_CHECK = "resume-check"
DETERMINISTIC_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
#: the resume check's runs: phase i's, cut from 5 local epochs to 1
RESUME_FLAGS = HOST_FLAGS + ["--local-epochs", "1"]
#: the routed logits of serve --mode fl against a direct forward
SERVE_FL_TOL = 1e-5
#: the served batches of the steady-state serve figure (phase ii)
SERVE_FL_STEADY = ["--batch", "32", "--repeat", "64"]
#: the bf16 model of the zoo (phase iii), cut from 5 local epochs to 1 (its
#: local phase is ~3x the CNN's a step), and the shape its rounds give the
#: fused kernels: N = 10, K = 3, D = 27,626 bf16
TINY_ARGS = ["--mode", "fl", "--model", "transformer_tiny", "--rounds",
             str(ROUNDS), "--local-epochs", "1"]
TINY = (10, 3, 27_626)
#: the sharded federation (phases j and k): the main path on a one-rank
#: mesh, its sketch path on it, and the round on 2 gloo ranks sharing the
#: card at the CNN's D and at 8M
MESH_ARGS = ["--mode", "fl", "--rounds", str(3), "--mesh", "data=1"]
MESH_SKETCH_ARGS = ["--mode", "fl", "--method", "coalition_topk", "--sketch",
                    "rproj", "--sketch-dim", "256", "--mesh", "data=1",
                    "--rounds", "2"]
SHARD_RANKS = 2
SHARD_D = (582_026, 8_000_000)
#: phase l: one moonshot-v1-16b-a3b MoE layer at full width in f32, on
#: 4 x 32 tokens, expert parallelism at world 1 against the dense layer
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_TOKENS = (4, 32)
MOE_TOL = 2e-4
#: phase m: hymba-1.5b in full, REMAT_STEPS Adam steps with and without
#: remat from one init and batches; later losses within 1e-6 relative
#: (remat runs the same forward again, so the losses agree but for the
#: order of a reduction)
REMAT_STEPS = 3
REMAT_RTOL = 1e-6
#: phase n: the dry-run (``repro_torch.launch.dryrun``) on the card.  Its
#: CLI as subprocesses on the default device (fake CUDA tensors), each with
#: the line it must print; then at world 1 (a fake group of one, mesh
#: data=1, model=1) two steps traced on fake tensors and run for real under
#: the same counting mode: hymba-1.5b's Adam step at phase m's batch with
#: remat off, and the paper-CNN FL round at N = 256 on ``stream``; traced
#: against real FLOPs and bytes within 1%, peak memory within 10%; and a
#: toy on a (4, 4) fake mesh, a rank's FLOPs x 16 equal to the unsharded
DRYRUN_RUNS = ((["--arch", "chatglm3-6b", "--shape", "decode_32k", "--mesh",
                 "both"], "2 ok"),
               (["--fl"], "FL coalition round"),
               # the SSM scan as one operator: the two SSM archs' train and
               # prefill steps trace at full length on the 16x16 mesh
               (["--arch", "falcon-mamba-7b", "--shape", "train_4k"],
                "1 ok, 0 skipped"),
               (["--arch", "hymba-1.5b", "--shape", "prefill_32k"],
                "1 ok, 0 skipped"))
DRYRUN_RTOL = {"flops": 0.01, "bytes": 0.01, "peak": 0.10}
#: the hymba step's traced FLOPs to 7 digits: the registry's count of the
#: SSM chunk loop run inline, which the scan operator's counts keep
DRYRUN_HYMBA_FLOPS = "1.257711e+13"
DRYRUN_FL_CLIENTS = 256
DRYRUN_BATCH = (10, 129)
#: the toy's hidden widths on a (4, 4) fake mesh: one the model axis
#: divides, one it does not
DRYRUN_TOY_HIDDEN = (128, 130)
#: the world-1 traces run as ``chip_smoke.py DRYRUN_TRACE OUT``
DRYRUN_TRACE = "dryrun-trace"
#: the DP phase's noise multiplier and the bound on its residual's std
DP_SIGMA = 0.5
DP_STD_RTOL = 0.02
#: the paper CNN's bytes in f32 (2 x this cross a link per model a round)
MODEL_BYTES = 2_328_104
#: server steps of the sketch path's run
SKETCH_ROUNDS = 2
SKETCH_ARGS = ["--mode", "fl", "--method", "coalition_topk", "--sketch",
               "rproj", "--sketch-dim", "256"]
#: the distance and segment-sum kernels' checks: (N, K, D, dtype name)
DIST_CHECKS = ((10, 3, 582_026, "float32"), (10, 3, 582_026, "bfloat16"),
               (10, 3, 8_000_000, "float32"), (10, 3, 1, "float32"),
               (10, 3, 64, "float32"), (10, 3, 255, "float32"),
               (10, 3, 256, "float32"), (10, 3, 1024, "float32"),
               (10, 3, 2048, "float32"), (10, 3, 256, "bfloat16"),
               (64, 8, 1_000_003, "float32"), (16, 4, 70_001, "bfloat16"))
#: the sketch width of the sketch path, and the framework-scale D
SKETCH_DIM = 256
BIG_D = 8_000_000
#: H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s,
#: fp32 FLOP/s outside the tensor cores, bf16 FLOP/s of the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
REPLACES = {"center_sq_dists": "src/repro/kernels/fused_round.py:52",
            "fused_coalition_stats": "src/repro/kernels/fused_round.py:100",
            "pairwise_sq_dists": "src/repro/kernels/pairwise_dist.py:42",
            "sq_dists_to_points": "src/repro/kernels/pairwise_dist.py:86",
            "segment_sum": "src/repro/kernels/segment_mean.py:26",
            "flash_attention": "src/repro/kernels/flash_attention.py:73"}
_CSRC = "src/repro_torch/kernels/csrc/"
#: the CNN's first block as a kernel pair (``kernels/conv_pool.py``): it
#: replaces no TPU kernel
CNN_BLOCK = ("conv_relu_pool_fwd", "conv_relu_pool_wgrad")
#: its shapes, (clients C, images a client B): the FL local phase's vmapped
#: step of the benchmark's cell and the evaluation's one call
CONV_POOL_SHAPES = ((100, 50), (1, 10_000))
SOURCES = {"conv_relu_pool_fwd": _CSRC + "conv_pool.cu",
           "conv_relu_pool_wgrad": _CSRC + "conv_pool.cu",
           "center_sq_dists": _CSRC + "fused_round.cu",
           "fused_coalition_stats": _CSRC + "fused_round.cu",
           "pairwise_sq_dists": _CSRC + "pairwise_dist.cu",
           "sq_dists_to_points": _CSRC + "pairwise_dist.cu",
           "segment_sum": _CSRC + "segment_mean.cu",
           "flash_attention": _CSRC + "flash_attention.cu"}
#: the pretrain path: hymba-1.5b in full (32 layers, 25 / 5 heads of 64,
#: window 1024, bf16), batch 10 of seq_len + 1 = 129 tokens, Adam
PRETRAIN_STEPS = 8
PRETRAIN_LR = "1e-3"
PRETRAIN_ARGS = ["--mode", "pretrain", "--flash", "--lr", PRETRAIN_LR,
                 "--steps", str(PRETRAIN_STEPS)]
#: the attention shape the pretrain path gives the kernel, in bf16:
#: (B, Hq, Hkv, Sq, Skv, Dh, causal, window)
FLASH_PATH = (10, 25, 5, 129, 129, 64, True, 1024)
#: the reference's sweep (tests/test_kernels.py): (B, Hq, Hkv, Sq, Skv, Dh,
#: causal, window), run in f32 and in bf16
FLASH_SWEEP = ((1, 4, 1, 128, 128, 64, True, None),
               (2, 8, 2, 256, 256, 64, True, None),
               (1, 2, 2, 64, 64, 128, False, None),
               (1, 4, 4, 100, 100, 80, True, None),
               (2, 4, 2, 1, 300, 64, True, None),
               (1, 4, 1, 256, 256, 64, True, 64),
               (1, 4, 2, 64, 192, 64, True, None))
#: the long windowed hymba shape that is timed beside the path's
FLASH_LONG = (1, 25, 5, 4096, 4096, 64, True, 1024)
#: the serve path's shape: seamless-m4t-large-v2's encoder (16 heads of 64
#: over the stub's 960 frames, batch 4), non-causal, once a layer a prefill
FLASH_ENCODER = (4, 16, 16, 960, 960, 64, False, None)
#: the path's shape, the long windowed hymba shape, ragged q-tiles against a
#: longer timeline and the Dh 96 / 128 archs' shapes, bf16: (B, Hq, Hkv, Sq,
#: Skv, Dh, causal, window)
FLASH_BF16 = (FLASH_PATH, (10, 25, 5, 128, 128, 64, True, 1024),
              FLASH_LONG, FLASH_ENCODER, (2, 8, 2, 17, 300, 64, True, None),
              (1, 32, 32, 704, 704, 96, True, None),
              (1, 36, 4, 2048, 2048, 128, True, None))
#: kernel vs plain attention: the reference's rtol = atol, by dtype
#: (tests/test_kernels.py:108,118), and its gradient bound (:130)
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
FLASH_GRAD_TOL = 2e-3
#: the losses of one full-size forward with and without the kernel
FORWARD_RTOL = 1e-2
#: the serve phases: ``serve --mode lm --full --arch A`` at the CLI's other
#: defaults (batch 4, prompt 32, 16 new tokens, greedy, seed 0), with the
#: CLI's extra flags, one full-width model at a time
SERVE_PHASES = (("falcon-mamba-7b", ()), ("hymba-1.5b", ()),
                ("seamless-m4t-large-v2", ("--flash",)),
                ("phi-3-vision-4.2b", ()), ("moonshot-v1-16b-a3b", ()))
#: the serve gates' bounds, max abs error over the max, by dtype: (c)
#: decode against forward (prefill S - 1 tokens + one decode step against
#: the full forward's last logits) and (d) the encoder through the kernel
#: against the plain attention (memory and prefill logits).  In bf16, as
#: served: bf16 rounding, amplified over 24-64 random layers, moves the
#: last logits by 1e-2-4e-2 of their max between the (B·S)- and (B)-row
#: GEMMs (and by more when the same forward runs its rows one at a time),
#: and the encoder memory by 2e-2 under the library's SDPA in place of the
#: plain attention (both printed); in f32, the same weights cast, with an
#: f32 cache: the cache path and the kernel alone (PERF.md §6)
SERVE_RTOL = {"bfloat16": 5e-2, "float32": 1e-4}
#: f32 bytes of the model the f32 check may hold: the served model's
#: leading layers that fit (all of them but moonshot's)
SERVE_F32_BYTES = 40 * 2**30
#: decode steps traced with torch.profiler in each serve phase
DECODE_TRACED = 4
#: the MoE capacity factor of that check (tests/test_archs.py:36), so that
#: no routing drop can differ between T = B·S and T = B
SERVE_CHECK_CF = 8.0


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


def stale_weights(n: int):
    """(N,) staleness-decayed masses (1 + tau)^-0.5, tau = 0..4 in turn, on
    the card: the semi_async engine's client weights."""
    import torch

    from repro_torch import sim

    return sim.staleness_weights(torch.arange(n, device="cuda") % 5, 0.5)


def fractional_m(n: int, k: int, seed: int = 0):
    """(K, N) aggregation matrix of staleness-decayed masses: a seeded
    assignment and centers, the denominators as the port's
    ``aggregation_matrix`` takes them."""
    import torch

    from repro_torch.core import fused

    g = torch.Generator(device="cuda").manual_seed(seed)
    assign = torch.randint(0, k, (n,), generator=g, device="cuda")
    centers = torch.randperm(n, generator=g, device="cuda")[:k]
    oh_eff, _, denom = fused.aggregation_matrix(assign, k, centers,
                                                stale_weights(n))
    return (oh_eff / denom[:, None]).contiguous()


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / (float(want.abs().max()) + 1e-12)


def path_run(fn):
    """Run ``fn`` with every launch counter set to 0 just before.  Returns
    its result, the counters just after, and how many of those launches of
    ``sq_dists_to_points``, ``segment_sum`` and ``pairwise_sq_dists`` took
    each (kernel, route, D): each wrapper asks its module's route function
    once a launch, and that function is wrapped for the run to record its
    answers."""
    import collections

    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise_dist as pd
    from repro_torch.kernels import segment_mean as sm

    routes = collections.Counter()
    # (module, route function's name, kernel, position of D in its args)
    recorded = ((pd, "route", "sq_dists_to_points", 2),
                (sm, "route", "segment_sum", 2),
                (pd, "pairwise_route", "pairwise_sq_dists", 1))
    saved = [getattr(mod, fname) for mod, fname, _, _ in recorded]

    def recording(original, name, at):
        def route(*args):
            got = original(*args)
            routes[(name, got, args[at])] += 1
            return got
        return route

    for (mod, fname, name, at), original in zip(recorded, saved):
        setattr(mod, fname, recording(original, name, at))
    try:
        ops.reset_launch_counts()
        out = fn()
        launches = ops.launch_counts()
    finally:
        for (mod, fname, _, _), original in zip(recorded, saved):
            setattr(mod, fname, original)
    for _, _, name, _ in recorded:
        count = sum(c for (kn, _, _), c in routes.items() if kn == name)
        if count != launches[name]:
            fail(f"{name}: {launches[name]} launches, but {count} routes "
                 f"asked for")
    return out, launches, routes


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
        route = fr.route(n, k, d, w.dtype, w.data_ptr())
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
            print(f"check {name} N={n} K={k} D={d} {dname} (route "
                  f"{route}): max abs err {worst_abs:.3e}, / max "
                  f"{worst_rel:.3e} (bound {TOL:.0e}), launches +{moved}")
            if not worst_rel <= TOL:
                fail(f"{name} disagrees with its plain version at N={n} "
                     f"K={k} D={d} {dname}")
            if moved != 1:
                fail(f"{name}'s launch counter moved by {moved}, not 1")
            if (n, k, d) == MAIN and dname == "float32":
                errs[name] = worst_abs
        del w, got, want, b, theta, med, b_ref, theta_ref, med_ref
        torch.cuda.empty_cache()
    check_fractional_masses()
    return errs


def check_fractional_masses() -> None:
    """Phase c: fused_coalition_stats at the main shape, f32 and bf16, with
    an aggregation matrix of staleness-decayed masses (what the semi_async
    engine gives it), against its plain version; its counter moves by 1."""
    import torch

    from repro_torch.kernels import fused_round as fr
    from repro_torch.kernels import ref

    t0 = time.perf_counter()
    n, k, d = MAIN
    m = fractional_m(n, k, seed=7)
    print(f"fractional aggregation matrix (K, N) = {tuple(m.shape)}: rows "
          f"{[[round(x, 4) for x in row] for row in m.tolist()]}")
    for dname in ("float32", "bfloat16"):
        w, _, _ = inputs(n, k, d, getattr(torch, dname), seed=8)
        route = fr.route(n, k, d, w.dtype, w.data_ptr())
        before = fr.LAUNCHES["fused_coalition_stats"]
        got = fr.fused_coalition_stats(w, m)
        torch.cuda.synchronize()
        moved = fr.LAUNCHES["fused_coalition_stats"] - before
        pairs = [rel_err(g, r) for g, r in
                 zip(got, ref.fused_coalition_stats(w, m))]
        worst_abs = max(a for a, _ in pairs)
        worst_rel = max(r for _, r in pairs)
        print(f"check fused_coalition_stats N={n} K={k} D={d} {dname} "
              f"fractional masses (route {route}): max abs err "
              f"{worst_abs:.3e}, / max {worst_rel:.3e} (bound {TOL:.0e}), "
              f"launches +{moved}")
        if not worst_rel <= TOL:
            fail(f"fused_coalition_stats disagrees with its plain version "
                 f"under fractional masses at {dname}")
        if moved != 1:
            fail(f"fused_coalition_stats's launch counter moved by {moved}, "
                 f"not 1")
        del w, got
    torch.cuda.empty_cache()
    print(f"phase c (fractional masses): {time.perf_counter() - t0:.1f} s")


def check_dist_kernels() -> dict:
    """Phase 3, the distance and segment-sum kernels against their plain
    versions; returns the max abs errors by (kernel, N, K, D)."""
    import torch

    from repro_torch.kernels import pairwise_dist as pd
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_mean as sm

    errs = {}
    for n, k, d, dname in DIST_CHECKS:
        dtype = getattr(torch, dname)
        w, _, m = inputs(n, k, d, dtype, seed=2)
        g = torch.Generator(device="cuda").manual_seed(3)
        p = torch.randn((k, d), generator=g, device="cuda").to(dtype)
        routes = {"sq_dists_to_points": pd.route(n, k, d, w.dtype,
                                                 w.data_ptr(), p.dtype,
                                                 p.data_ptr()),
                  "segment_sum": sm.route(n, k, d, w.dtype, w.data_ptr()),
                  "pairwise_sq_dists": pd.pairwise_route(n, d, w.dtype,
                                                         w.data_ptr())}
        before = {**pd.LAUNCHES, **sm.LAUNCHES}
        got = {"sq_dists_to_points": pd.sq_dists_to_points(w, p),
               "segment_sum": sm.segment_sum(m, w),
               "pairwise_sq_dists": pd.pairwise_sq_dists(w)}
        torch.cuda.synchronize()
        after = {**pd.LAUNCHES, **sm.LAUNCHES}
        want = {"sq_dists_to_points": ref.sq_dists_to_points(w, p),
                "segment_sum": ref.segment_sum(m, w),
                "pairwise_sq_dists": ref.pairwise_sq_dists(w)}
        for name in got:
            err, rel = rel_err(got[name], want[name])
            moved = after[name] - before[name]
            print(f"check {name} N={n} K={k} D={d} {dname} (route "
                  f"{routes[name]}): max abs err {err:.3e}, / max {rel:.3e} "
                  f"(bound {TOL:.0e}), launches +{moved}")
            if not rel <= TOL:
                fail(f"{name} disagrees with its plain version at N={n} "
                     f"K={k} D={d} {dname}")
            if moved != 1:
                fail(f"{name}'s launch counter moved by {moved}, not 1")
            errs[(name, n, k, d)] = err
        pw = got["pairwise_sq_dists"]
        if not (torch.all(torch.diagonal(pw) == 0) and torch.equal(pw, pw.T)
                and torch.all(pw >= 0) and torch.all(
                    got["sq_dists_to_points"] >= 0)
                and torch.equal(pd.pairwise_sq_dists(w), pw)):
            fail(f"pairwise_sq_dists at N={n} D={d}: diagonal not exactly 0, "
                 f"not symmetric, a distance below 0, or a repeat that "
                 f"differs")
        del w, p, m, got, want
        torch.cuda.empty_cache()
    return errs


def check_rounds():
    """Phase 4: whole rounds on the cuda backend against the stream one at
    the main width: fused, composed, and sketched (rproj, countsketch), and
    the fused and countsketch rounds under client weights (phase d), each
    with the counters set to 0 just before.  Returns the routes of the
    composed round's launches (see :func:`path_run`)."""
    import torch

    from repro_torch.core import coalitions, sketch

    n, k, d = MAIN
    w, _, _ = inputs(n, k, d, torch.float32, seed=1)
    w += 5.0 * (torch.arange(n, device="cuda") % k)[:, None]  # separated
    state = coalitions.init_centers(w, k, perm=torch.arange(n))
    variants = [("fused", {}, {"center_sq_dists": 1,
                               "fused_coalition_stats": 1}),
                ("composed", {"fused": False}, {"sq_dists_to_points": 2,
                                                "segment_sum": 1})]
    variants += [(f"sketched {name} S={SKETCH_DIM}",
                  {"sketcher": sketch.make_sketcher(name, dim=SKETCH_DIM)},
                  {"sq_dists_to_points": 2, "segment_sum": 1})
                 for name in ("rproj", "countsketch")]
    # phase d: the fused and countsketch rounds again under staleness
    # weights, the last client at 0 (it must not be elected; each coalition
    # keeps three members of positive mass)
    weights = stale_weights(n)
    weights[n - 1] = 0.0
    variants += [(f"{label} weighted", {**kw, "client_weights": weights},
                  launches) for label, kw, launches in variants
                 if label in ("fused", f"sketched countsketch S={SKETCH_DIM}")]
    composed = None
    for label, kw, launches in variants:
        t0 = time.perf_counter()
        def cuda_round():
            rc = coalitions.run_round(w, state, backend="cuda", **kw)
            torch.cuda.synchronize()
            return rc
        rc, counts, routes = path_run(cuda_round)
        moved = {name: c for name, c in counts.items() if c}
        if label == "composed":
            composed = routes
        rs = coalitions.run_round(w, state, backend="stream", **kw)
        same = (torch.equal(rc.assignment, rs.assignment)
                and torch.equal(rc.new_center_idx, rs.new_center_idx))
        _, theta_err = rel_err(rc.theta, rs.theta)
        print(f"round {label} cuda vs stream: assignment and centers equal: "
              f"{same}, theta err / max {theta_err:.3e}, launches {moved}")
        if not same or not theta_err <= TOL:
            fail(f"the cuda backend's {label} round disagrees with the "
                 f"stream backend's")
        if moved != launches:
            fail(f"the {label} round launched {moved}, expected {launches}")
        if routes:
            print(f"round {label}: launches by (kernel, route, D) "
                  f"{dict(routes)}")
        if "client_weights" in kw:
            centers = rc.new_center_idx.tolist()
            print(f"round {label}: weights "
                  f"{[round(x, 4) for x in weights.tolist()]}, counts "
                  f"{[round(x, 4) for x in rc.counts.tolist()]}, centers "
                  f"{centers} ({time.perf_counter() - t0:.2f} s)")
            if n - 1 in centers:
                fail(f"the {label} round elected client {n - 1} of weight 0")
    return composed


def time_ms(fn, reps: int = 50, warmup: int = 5,
            clean: bool = False) -> float:
    """Median ms of ``fn`` on the card, by CUDA events around each call,
    with the 50 MB L2 cache flushed before each.  The flush writes 1 GiB
    (~0.3 ms of device time), so the card is still busy with it while the
    host enqueues the call: the events time the device, not the host.  It
    leaves ~50 MB of dirty lines in the L2, whose write-back shares device
    memory with the timed call.  ``clean``: after the flush, read a 128 MB
    buffer (over twice the L2) before the start event, so those lines are
    written back outside the timed window and the call finds a clean,
    cold L2."""
    import torch

    buf = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    sweep = torch.zeros(2**25, dtype=torch.float32, device="cuda") \
        if clean else None
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        buf.zero_()
        if clean:
            sweep.sum()
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


def bound(nbytes: float, ops: float,
          peak: float = PEAK_FP32) -> tuple[float, str]:
    """The least time in ms the card could take: bytes over the memory rate
    or operations over the peak for their type, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def timed_row(label: str, kernel, plain, library, nbytes: float,
              ops: float, peak: float = PEAK_FP32,
              clean: bool = False) -> dict:
    """Time a kernel, its plain version and its library yardstick (None if
    there is none) on the card; print them beside the bound.  ``clean``:
    also the kernel with a clean L2 (``time_ms(clean=True)``)."""
    bound_ms, bound_by = bound(nbytes, ops, peak)
    row = {"ms": time_ms(kernel), "plain_ms": time_ms(plain),
           "library_ms": None if library is None else time_ms(library),
           "bound_ms": bound_ms, "bound_by": bound_by}
    enqueue = row["host_us"] = host_us(kernel)
    lib = row["library_ms"]
    print(f"time {label}, L2 flushed: kernel {row['ms']:.4f} ms "
          f"({nbytes / row['ms'] / 1e6:.1f} GB/s), plain "
          f"{row['plain_ms']:.4f} ms, library "
          f"{'-' if lib is None else f'{lib:.4f}'} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); wrapper host time "
          f"{enqueue:.1f} us")
    if clean:
        ms = row["clean_ms"] = time_ms(kernel, clean=True)
        print(f"time {label}, clean L2: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s, "
              f"{100 * bound_ms / ms:.1f}% of the bound)")
    return row


def time_kernels() -> dict:
    """Phase 5: kernel, plain and library times with bounds at the main
    path's shapes: the main width for all five kernels (the library
    yardsticks: torch.cdist, squared where the kernel squares, and cuBLAS's
    mix @ W), each also with a clean L2, and sq_dists_to_points on the
    sketch path's (N, S) sketch too, with a one-element fill as the launch
    floor.  Returns the rows of the kernels line by kernel name:
    sq_dists_to_points at the sketch path's shape, and its full-width row
    under "sq_dists_to_points full"."""
    import torch

    from repro_torch.kernels import fused_round as fr
    from repro_torch.kernels import pairwise_dist as pd
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_mean as sm

    n, k, d = MAIN
    w, conehot, m = inputs(n, k, d, torch.float32)
    centers = (conehot @ w).contiguous()
    s = SKETCH_DIM
    s_w = torch.randn((n, s), device="cuda")
    s_p = s_w[:k].contiguous()
    wb = n * d * 4
    pairs = n * (n - 1) // 2
    pair_route = pd.pairwise_route(n, d, w.dtype, w.data_ptr())
    out = {
        "center_sq_dists": timed_row(
            f"center_sq_dists N={n} K={k} D={d} f32",
            lambda: fr.center_sq_dists(w, conehot),
            lambda: ref.center_sq_dists(w, conehot),
            lambda: torch.cdist(w, centers),
            wb + 4 * (k * n + n * k), 2 * k * n * d + 3 * n * k * d,
            clean=True),
        "fused_coalition_stats": timed_row(
            f"fused_coalition_stats N={n} K={k} D={d} f32",
            lambda: fr.fused_coalition_stats(w, m),
            lambda: ref.fused_coalition_stats(w, m), None,
            wb + 4 * (k * n + k * d + d + n * k),
            2 * k * n * d + k * d + d + 3 * n * k * d, clean=True),
        "segment_sum": timed_row(
            f"segment_sum K={k} N={n} D={d} f32 (route "
            f"{sm.route(n, k, d, w.dtype, w.data_ptr())})",
            lambda: sm.segment_sum(m, w), lambda: ref.segment_sum(m, w),
            lambda: m @ w, wb + 4 * (k * n + k * d), 2 * k * n * d,
            clean=True),
        "pairwise_sq_dists": timed_row(
            f"pairwise_sq_dists N={n} D={d} f32 (route {pair_route})",
            lambda: pd.pairwise_sq_dists(w),
            lambda: ref.pairwise_sq_dists(w),
            lambda: torch.cdist(w, w) ** 2, wb + 4 * n * n,
            3 * pairs * d, clean=True)}
    out["segment_sum"]["kernel_route"] = sm.route(n, k, d, w.dtype,
                                                  w.data_ptr())
    out["pairwise_sq_dists"]["kernel_route"] = pair_route
    full_route = pd.route(n, k, d, w.dtype, w.data_ptr(), centers.dtype,
                          centers.data_ptr())
    out["sq_dists_to_points full"] = timed_row(
        f"sq_dists_to_points N={n} K={k} D={d} f32 (full W, route "
        f"{full_route})",
        lambda: pd.sq_dists_to_points(w, centers),
        lambda: ref.sq_dists_to_points(w, centers),
        lambda: torch.cdist(w, centers) ** 2,
        wb + 4 * (k * d + n * k), 3 * n * k * d, clean=True)
    out["sq_dists_to_points full"]["kernel_route"] = full_route
    print(f"time pairwise Gram yardstick w @ w.T N={n} D={d}: "
          f"{time_ms(lambda: w @ w.T):.4f} ms")
    out["sq_dists_to_points"] = timed_row(
        f"sq_dists_to_points N={n} K={k} D=S={s} f32 (sketch)",
        lambda: pd.sq_dists_to_points(s_w, s_p),
        lambda: ref.sq_dists_to_points(s_w, s_p),
        lambda: torch.cdist(s_w, s_p) ** 2, 4 * (n * s + k * s + n * k),
        3 * n * k * s)
    out["sq_dists_to_points"]["kernel_route"] = pd.route(
        n, k, s, s_w.dtype, s_w.data_ptr(), s_p.dtype, s_p.data_ptr())
    print_read_floor(w)
    print_sweep_floor(n, k)
    one = torch.zeros(1, device="cuda")
    print(f"time launch floor (one-element fill): "
          f"{time_ms(lambda: one.fill_(1.0)):.4f} ms, host "
          f"{host_us(lambda: one.fill_(1.0)):.1f} us")
    return out


def time_conv_pool() -> dict:
    """Phase 5a: the CNN block's two kernels at CONV_POOL_SHAPES against
    their plain versions, and timed beside their bounds, the plain versions
    and the library's yardstick: ATen's grouped ``F.conv2d`` + ReLU +
    ``max_pool2d`` as the vmapped module ran them, and their autograd
    backward to the weights (timed only; the port calls neither).  The
    forward's pooled values within TOL of the max, its argmax equal to the
    plain version's wherever the window's two largest values part by more
    than 2 TOL of the max (the near-ties counted, and at least half the
    windows clear); the weight gradient, from the plain version's argmax
    and pooled values on both sides, within TOL x sqrt(B / 50) (it sums
    B x 144 products a weight, whose round-off grows as the square root).
    Bounds: the bytes of ``forward_cost`` / ``weight_grad_cost``; the
    forward's operations theirs (4 x 25 FMAs a pooled value), the weight
    gradient's 25 FMAs and the bias a pooled value, since only a window's
    maximum carries gradient.  Returns the rows by (kernel name, C, B),
    each with its max abs error under "err"."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import conv_pool as cp

    out = {}
    for c, n in CONV_POOL_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(c * 100_003 + n)
        x = torch.rand((c, n, 1, 28, 28), device="cuda", generator=gen)
        w = torch.randn((c, 32, 1, 5, 5), device="cuda", generator=gen) * 0.2
        b = torch.randn((c, 32), device="cuda", generator=gen) * 0.1
        g = torch.randn((n, c, 32, 12, 12), device="cuda", generator=gen)
        y, argmax = cp.kernel_forward(x, w, b)
        want_y, want_arg = cp.plain_forward(x, w, b)
        dw, db = cp.kernel_weight_grad(g, want_arg, want_y, x)
        want_w, want_b = cp.plain_weight_grad(g, want_arg, want_y, x)
        xg = x.transpose(0, 1).reshape(n, c, 28, 28)
        pre = F.conv2d(xg, w.reshape(c * 32, 1, 5, 5), b.reshape(-1),
                       groups=c)
        win = F.relu(pre).reshape(n, c, 32, 12, 2, 12, 2).permute(
            0, 1, 2, 3, 5, 4, 6).reshape(n, c, 32, 12, 12, 4)
        top2 = win.topk(2, dim=-1).values
        clear = top2[..., 0] - top2[..., 1] > \
            2 * TOL * float(want_y.abs().max())
        del pre, win, top2
        torch.cuda.synchronize()
        errs = {"conv_relu_pool_fwd": rel_err(y, want_y),
                "conv_relu_pool_wgrad": max(rel_err(dw, want_w),
                                            rel_err(db, want_b),
                                            key=lambda e: e[1])}
        differ = argmax != want_arg
        flips, ties = int(differ[clear].sum()), int(differ[~clear].sum())
        share = float(clear.float().mean())
        print(f"conv_relu_pool C={c} B={n}: forward max error "
              f"{errs['conv_relu_pool_fwd'][1]:.3e} of the max, argmax "
              f"differs at {flips} of {int(clear.sum())} clear windows "
              f"({share:.1%}) and {ties} near-ties, weight gradient "
              f"{errs['conv_relu_pool_wgrad'][1]:.3e}")
        tols = {"conv_relu_pool_fwd": TOL,
                "conv_relu_pool_wgrad": TOL * max(1.0, math.sqrt(n / 50))}
        for name, (_, rel) in errs.items():
            if rel > tols[name]:
                fail(f"{name} at C={c} B={n}: max error {rel:.3e} of the "
                     f"max, over {tols[name]:.3e}")
        if flips or share <= 0.5:
            fail(f"conv_relu_pool_fwd at C={c} B={n}: the argmax differs "
                 f"from the plain version's at {flips} clear windows "
                 f"(clear: {share:.1%} of the windows)")
        wl = w.reshape(c * 32, 1, 5, 5).clone().requires_grad_()
        bl = b.reshape(-1).clone().requires_grad_()

        def library_forward():
            return F.max_pool2d(F.relu(F.conv2d(xg, wl, bl, groups=c)), 2)

        lib_out, gl = library_forward(), g.reshape(n, c * 32, 12, 12)
        fwd_ops, fwd_bytes, _ = cp.forward_cost(x, w, b)
        _, wgrad_bytes, _ = cp.weight_grad_cost(g, argmax, y, x)
        wgrad_ops = y.numel() * (cp.K * cp.K * 2 + 1)
        shape = f"C={c} B={n} f32"
        rows = {"conv_relu_pool_fwd": timed_row(
            f"conv_relu_pool_fwd {shape}",
            lambda: cp.kernel_forward(x, w, b),
            lambda: cp.plain_forward(x, w, b), library_forward,
            fwd_bytes, fwd_ops),
            "conv_relu_pool_wgrad": timed_row(
            f"conv_relu_pool_wgrad {shape}",
            lambda: cp.kernel_weight_grad(g, argmax, y, x),
            lambda: cp.plain_weight_grad(g, argmax, y, x),
            lambda: torch.autograd.grad(lib_out, (wl, bl), gl,
                                        retain_graph=True),
            wgrad_bytes, wgrad_ops)}
        for name, row in rows.items():
            row["err"] = errs[name][0]
            out[(name, c, n)] = row
        del lib_out
    return out


def print_sweep_floor(n: int, k: int) -> None:
    """The fixed cost of a register sweep on the main path's grid: the
    full-width kernels at one step of the grid (D = 1024 columns a SM less
    2, so that each loads 2 columns at a time with one CTA a SM), clean L2.
    The distances' launches end in the last CTA's sum of every CTA's row;
    the segment sum's has no tail."""
    import torch

    from repro_torch.kernels import pairwise_dist as pd
    from repro_torch.kernels import segment_mean as sm

    d = 1024 * torch.cuda.get_device_properties(0).multi_processor_count - 2
    w = torch.randn((n, d), device="cuda")
    p = w[:k].contiguous()
    mix = torch.ones((k, n), device="cuda") / n
    dist_route = pd.route(n, k, d, w.dtype, w.data_ptr(), p.dtype,
                          p.data_ptr())
    pair_route = pd.pairwise_route(n, d, w.dtype, w.data_ptr())
    sum_route = sm.route(n, k, d, w.dtype, w.data_ptr())
    dist_us = time_ms(lambda: pd.sq_dists_to_points(w, p), clean=True) * 1e3
    pair_us = time_ms(lambda: pd.pairwise_sq_dists(w), clean=True) * 1e3
    sum_us = time_ms(lambda: sm.segment_sum(mix, w), clean=True) * 1e3
    print(f"time one step of the sweep N={n} K={k} D={d} f32, clean L2: "
          f"sq_dists_to_points (route {dist_route}, with the last CTA's sum) "
          f"{dist_us:.3f} us, pairwise_sq_dists (route {pair_route}, with "
          f"the last CTA's sum) {pair_us:.3f} us, segment_sum (route "
          f"{sum_route}, no tail) {sum_us:.3f} us")


def print_flash_attributes() -> None:
    """Each flash_attention kernel's registers, shared memory and spills, as
    the CUDA runtime reports them (cudaFuncGetAttributes)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    for dtype in (torch.bfloat16, torch.float32):
        for dh in fa.HEAD_DIMS:
            a = fa.kernel_attributes(dtype, dh)
            print(f"flash_attention {str(dtype)[6:]} Dh={dh}: {a['regs']} "
                  f"registers a thread, {a['threads']} threads, shared "
                  f"memory {a['static_smem']} static + {a['dynamic_smem']} "
                  f"dynamic bytes a CTA, {a['local_bytes']} bytes of local "
                  f"memory (spills) a thread")


def check_sweep_attributes() -> None:
    """The registers a thread and local memory (spills) of every route of
    the fused round's two passes, sq_dists_to_points (each W / points dtype
    mix), pairwise_sq_dists and segment_sum, and of the CNN block's two
    kernels, as the CUDA runtime reports them; fails on any spill."""
    import torch

    from repro_torch.kernels import conv_pool as cp
    from repro_torch.kernels import fused_round as fr
    from repro_torch.kernels import pairwise_dist as pd
    from repro_torch.kernels import segment_mean as sm

    dtypes = (torch.float32, torch.bfloat16)
    kernels = [(f"fused_round {name} {str(dt)[6:]} pass {2 if stats else 1}",
                lambda n=name, d=dt, st=stats: fr.kernel_attributes(st, d, n))
               for name in fr.ROUTES for dt in dtypes
               for stats in (False, True)]
    kernels += [(f"sq_dists_to_points {name} W {str(wd)[6:]} P {str(pt)[6:]}",
                 lambda n=name, a=wd, b=pt: pd.kernel_attributes(a, b, n))
                for name in pd.ROUTES for wd in dtypes for pt in dtypes]
    kernels += [(f"pairwise_sq_dists {name} {str(dt)[6:]}",
                 lambda n=name, d=dt: pd.pairwise_kernel_attributes(d, n))
                for name in pd.PAIRWISE_ROUTES for dt in dtypes]
    kernels += [(f"segment_sum {name} {str(dt)[6:]}",
                 lambda n=name, d=dt: sm.kernel_attributes(d, n))
                for name in sm.ROUTES for dt in dtypes]
    kernels += [(f"conv_relu_pool_{which}",
                 lambda w=which: cp.kernel_attributes(w))
                for which in ("fwd", "wgrad")]
    for label, attributes in kernels:
        a = attributes()
        print(f"{label}: {a['regs']} registers a thread, {a['local_bytes']} "
              f"bytes of local memory (spills)")
        if a["local_bytes"]:
            fail(f"{label} spills")


def flash_inputs(shape, dtype, seed: int = 0):
    """q, k, v on the card for a (B, Hq, Hkv, Sq, Skv, Dh, ...) shape."""
    import torch

    b, hq, hkv, sq, skv, dh = shape[:6]
    g = torch.Generator(device="cuda").manual_seed(seed + sq * skv + hq)
    return [torch.randn(size, generator=g, device="cuda").to(dtype)
            for size in ((b, hq, sq, dh), (b, hkv, skv, dh),
                         (b, hkv, skv, dh))]


def check_flash() -> dict:
    """Phase 3, flash_attention against the plain attention: the
    reference's sweep in f32 and bf16, and the paths' and the larger archs'
    shapes in bf16, within the reference's rtol = atol; then the gradient
    through ops.flash_attention against the plain version's.  Returns the
    max abs error at the pretrain path's and the serve path's (the
    encoder's) shapes, by shape."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    cases = [(c, dn) for dn in ("float32", "bfloat16") for c in FLASH_SWEEP]
    cases += [(c, "bfloat16") for c in FLASH_BF16]
    path_errs = {}
    for shape, dname in cases:
        causal, window = shape[6:]
        q, k, v = flash_inputs(shape, getattr(torch, dname))
        before = fa.LAUNCHES["flash_attention"]
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        moved = fa.LAUNCHES["flash_attention"] - before
        want = ref.attention(q, k, v, causal=causal, window=window).float()
        diff = (got.float() - want).abs()
        err = float(diff.max())
        tol = FLASH_TOL[dname]
        excess = float((diff - tol * want.abs()).max())
        print(f"check flash_attention {shape} {dname}: max abs err {err:.3e}, "
              f"max(|err| - rtol |want|) {excess:.3e} (atol {tol:.0e}), "
              f"launches +{moved}")
        if got.dtype != q.dtype or not excess <= tol:
            fail(f"flash_attention disagrees with the plain attention at "
                 f"{shape} {dname}")
        if moved != 1:
            fail(f"flash_attention's launch counter moved by {moved}, not 1")
        if shape in (FLASH_PATH, FLASH_ENCODER) and dname == "bfloat16":
            path_errs[shape] = err
        del q, k, v, got, want, diff
    for shape in ((1, 4, 2, 64, 64, 64, True, None), FLASH_PATH):
        causal, window = shape[6:]
        q, k, v = (t.requires_grad_() for t in flash_inputs(shape,
                                                            torch.float32))
        got = torch.autograd.grad(ops.flash_attention(
            q, k, v, causal=causal, window=window).square().sum(), (q, k, v))
        want = torch.autograd.grad(ref.attention(
            q, k, v, causal=causal, window=window).square().sum(), (q, k, v))
        excess = max(float(((g - w).abs() - FLASH_GRAD_TOL * w.abs()).max())
                     for g, w in zip(got, want))
        print(f"check flash_attention gradient {shape} f32: "
              f"max(|err| - rtol |want|) {excess:.3e} (atol "
              f"{FLASH_GRAD_TOL:.0e})")
        if not excess <= FLASH_GRAD_TOL:
            fail(f"the gradient through ops.flash_attention disagrees with "
                 f"the plain version's at {shape}")
    torch.cuda.empty_cache()
    return path_errs


def time_flash() -> dict:
    """Phase 5, flash_attention at the pretrain path's shape (bf16): kernel,
    plain version and the library yardstick F.scaled_dot_product_attention
    (timed here, never called by the port), beside the bound: q, k, v read
    and out written once over the memory rate, or 4 Dh operations per kept
    (query, key) pair over the bf16 tensor-core peak.  Also the serve
    path's encoder shape (non-causal), and the long windowed hymba shape,
    printed only.  Returns the rows by shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rows = {}
    for shape in (FLASH_PATH, FLASH_ENCODER, FLASH_LONG):
        b, hq, hkv, sq, skv, dh, causal, window = shape
        q, k, v = flash_inputs(shape, torch.bfloat16)
        mask = ref.attention_mask(sq, skv, causal, window, "cuda")
        pairs = int(mask.sum())
        nbytes = 2 * (2 * b * hq * sq * dh + 2 * b * hkv * skv * dh)
        if window is not None and window < skv:     # the window hides keys
            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
        rows[shape] = timed_row(
            f"flash_attention {shape} bf16 ({pairs} pairs)",
            lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
            lambda: ref.attention(q, k, v, causal=causal, window=window),
            library, nbytes, 4 * b * hq * dh * pairs, PEAK_BF16)
        enqueue = rows[shape]["host_us"]
        device = rows[shape]["ms"] * 1e3
        print(f"flash_attention {shape} bf16: wrapper host time {enqueue:.1f} "
              f"us a call against kernel device time {device:.1f} us: "
              f"{'the host' if enqueue > device else 'the device'} is the "
              f"limit of back-to-back calls")
        del q, k, v
    torch.cuda.empty_cache()
    return rows


def report_rounds(out: dict, label: str, wall: float, launches: dict,
                  rounds: int) -> None:
    """Print a training run's per-round times and launches; fail unless it
    ran ``rounds`` rounds to a finite accuracy above chance (0.1)."""
    for r, (loc, srv) in enumerate(zip(out["local_s"], out["server_s"])):
        print(f"{label} round {r}: local phase {loc:.4f} s, server step "
              f"{srv:.4f} s")
    per_round = {name: c / rounds for name, c in launches.items()}
    print(f"{label}: {wall:.1f} s, launches {launches} ({per_round} per "
          f"round), test_acc {out['test_acc']}")
    acc = out["test_acc"][-1]
    if not (math.isfinite(acc) and acc > 0.1):
        fail(f"{label}: final test accuracy {acc} is not above chance")
    if len(out["test_acc"]) != rounds:
        fail(f"{label}: expected {rounds} rounds, got "
             f"{len(out['test_acc'])}")


def expect_launches(label: str, launches: dict, want: dict) -> None:
    """Fail unless each kernel launched as often as ``want`` says (0 for a
    kernel it does not name; the CNN block's kernels, which launch wherever
    the CNN trains or evaluates, only where ``want`` names them)."""
    for name, count in launches.items():
        if name in CNN_BLOCK and name not in want:
            continue
        if count != want.get(name, 0):
            fail(f"{label}: {name} launched {count} times, expected "
                 f"{want.get(name, 0)}")


def run_main_path() -> dict:
    """Phase 6: the port's training entry point, counters reset just before:
    the fused round's two kernels once per server step, the CNN block's
    weight gradient once a vmapped SGD step and its forward once a step and
    once an evaluation (one a round), no other kernel."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main(["--mode", "fl", "--rounds", str(ROUNDS)])
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    label = f"train --mode fl --rounds {ROUNDS}"
    report_rounds(out, label, wall, launches, ROUNDS)
    expect_launches(label, launches, {"center_sq_dists": ROUNDS,
                                      "fused_coalition_stats": ROUNDS})
    steps = main_path_steps()
    want = {"conv_relu_pool_wgrad": steps,
            "conv_relu_pool_fwd": steps + ROUNDS}
    if any(launches[name] != count for name, count in want.items()):
        fail(f"{label}: the CNN block launched {launches}; expected {want} "
             f"(the weight gradient once a vmapped step, the forward once a "
             f"step and once a round)")
    return launches, out["server_s"]


def main_path_steps() -> int:
    """The vmapped SGD steps of phase 6's run, from the training entry
    point's defaults: rounds x epochs x batches a client (a last, short
    batch too), each client holding the iid partition's equal share of the
    training set (MNIST's if its files are there, else ``--n-train``)."""
    import numpy as np

    from repro_torch.data import partition, synthetic
    from repro_torch.launch import train

    args = train.build_parser().parse_args(["--mode", "fl", "--rounds",
                                            str(ROUNDS)])
    if args.regime != "iid":
        fail(f"phase 6 counts steps on the iid partition, not "
             f"{args.regime}")
    real = synthetic.mnist_idx()
    n_train = args.n_train if real is None else len(real[0][1])
    n_local = partition.iid(np.arange(n_train) % 10, args.clients).shape[1]
    return args.rounds * args.local_epochs * -(-n_local // args.batch_size)


def run_fedavg_path() -> None:
    """Phase a: FedAvg on the semi_async engine over the ideal fleet through
    the training entry point, counters reset just before: no kernel
    launches; full participation; the flat rule's bytes, every model over
    the WAN both ways."""
    import torch

    from repro_torch.core import pytree
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import zoo

    model = zoo.make_model("cnn")
    nbytes = pytree.tree_bytes(model.init(torch.Generator().manual_seed(0)))
    if nbytes != MODEL_BYTES:
        fail(f"the paper CNN has {nbytes} bytes, not {MODEL_BYTES}")
    label = f"train {' '.join(FEDAVG_ARGS)}"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main(FEDAVG_ARGS)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    report_rounds(out, label, wall, launches, ROUNDS)
    expect_launches(label, launches, {})
    args = train.build_parser().parse_args(FEDAVG_ARGS)
    want_wan = round(ROUNDS * args.clients * 2 * MODEL_BYTES / 1e6, 3)
    print(f"{label}: fleet {out['fleet']}, sim_time_s {out['sim_time_s']}, "
          f"wan_MB {out['wan_MB']} (expected {want_wan}), edge_MB "
          f"{out['edge_MB']}, mean_participation "
          f"{out['mean_participation']}")
    if (out["method"] != "fedavg" or out["mean_participation"] != 1.0
            or out["wan_MB"] != want_wan or out["edge_MB"] != 0.0):
        fail(f"{label}: the substrate summary is not FedAvg's on the ideal "
             f"fleet")
    print(f"phase a (FedAvg, semi_async, ideal): {wall:.1f} s")


def run_straggler_path() -> None:
    """Phase b: Algorithm 1 on the semi_async engine over the
    cellular-flaky fleet through the training entry point, counters reset
    just before: each fused-round kernel once a round and nothing else; per
    round min(K, present) models over the WAN and every present one over
    the edge; fails if no round was partial (the kernels then saw no
    fractional masses)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    label = f"train {' '.join(STRAGGLER_ARGS)}"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main(STRAGGLER_ARGS)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    report_rounds(out, label, wall, launches, ROUNDS)
    expect_launches(label, launches, {"center_sq_dists": ROUNDS,
                                      "fused_coalition_stats": ROUNDS})
    hist = out["history"]
    args = train.build_parser().parse_args(STRAGGLER_ARGS)
    traffic = 2 * MODEL_BYTES
    for r, (part, sim_t, wan, edge) in enumerate(zip(
            hist.participation, hist.sim_times, hist.wan_bytes,
            hist.edge_bytes)):
        present = sum(part)
        print(f"{label} round {r}: participation {part} ({present} of "
              f"{len(part)}), sim_time {sim_t:.4f} s, WAN {wan:.0f} B, "
              f"edge {edge:.0f} B, counts {hist.trace.counts[r].tolist()}")
        if (wan != min(args.coalitions, present) * traffic
                or edge != present * traffic):
            fail(f"{label} round {r}: WAN {wan} / edge {edge} bytes are not "
                 f"the hierarchical schedule's for {present} present")
    max_wan = round(ROUNDS * args.coalitions * traffic / 1e6, 3)
    print(f"{label}: fleet {out['fleet']}, sim_time_s {out['sim_time_s']}, "
          f"wan_MB {out['wan_MB']} (at most {max_wan}), edge_MB "
          f"{out['edge_MB']}, mean_participation "
          f"{out['mean_participation']}")
    if all(all(part) for part in hist.participation):
        fail(f"{label}: every round had full participation, so no round "
             f"ran under fractional masses")
    if not out["wan_MB"] <= max_wan:
        fail(f"{label}: wan_MB {out['wan_MB']} exceeds {max_wan}")
    print(f"phase b (Algorithm 1, semi_async, cellular-flaky): {wall:.1f} s")


def run_event_path() -> None:
    """Phase e: Algorithm 1 on the event_driven engine over cellular-flaky
    with an energy budget, through the training entry point, counters reset
    just before: each fused-round kernel once at the census and once an
    event, nothing else; the clock never runs back; every device's spend is
    a whole number of its cycle's joules within the budget; some device
    retires and some survives."""
    import numpy as np
    import torch

    from repro_torch import sim
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    args = train.build_parser().parse_args(EVENT_ARGS)
    fleet = sim.make_fleet(args.fleet, args.clients, seed=args.sim_seed)
    e = sim.device_event_energy(fleet, MODEL_BYTES).numpy()
    # the dearest device pays its census and retires (0 J left); a device
    # of at most half that cost can afford another cycle and stays
    budget = float(e.max())
    print(f"phase e: budget {budget!r} J = the dearest cycle of the port's "
          f"{args.fleet} table at sim-seed {args.sim_seed} (cycle joules "
          f"{np.round(e, 3).tolist()}); devices costing more than "
          f"{budget / 2:.3f} J retire at the census")
    if not 2 * e.min() <= budget:
        fail("phase e: no device can afford a cycle after the census")
    argv = [*EVENT_ARGS, "--energy-budget", repr(budget)]
    label = f"train {' '.join(argv)}"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main(argv)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    report_rounds(out, label, wall, launches, EVENTS + 1)
    expect_launches(label, launches, {"center_sq_dists": EVENTS + 1,
                                      "fused_coalition_stats": EVENTS + 1})
    hist = out["history"]
    times = np.asarray(hist.event_times)
    spent = hist.trace.energy_spent
    for r in range(EVENTS + 1):
        print(f"{label} event {r}: t {times[r]:.4f} s, participation "
              f"{hist.participation[r]}, spent "
              f"{np.round(spent[r], 3).tolist()} J, retired "
              f"{hist.energy_exhausted[r]}")
    cycles = spent / e[None, :]
    if not np.all(np.diff(times) >= 0):
        fail(f"{label}: event times {times.tolist()} run back")
    if not np.allclose(cycles, np.rint(cycles), rtol=1e-5, atol=0):
        fail(f"{label}: spends are not whole cycles: {cycles.tolist()}")
    if not np.all(spent <= budget):
        fail(f"{label}: a device spent more than the {budget} J budget")
    if not 1 <= out["devices_exhausted"] < args.clients:
        fail(f"{label}: {out['devices_exhausted']} devices retired; the "
             f"budget should retire some and keep some")
    if not all(bool(torch.isfinite(v).all())
               for v in out["params"].values()):
        fail(f"{label}: θ is not finite")
    print(f"{label}: events {out['events']}, final_sim_time_s "
          f"{out['final_sim_time_s']}, energy_spent_j "
          f"{out['energy_spent_j']}, devices_exhausted "
          f"{out['devices_exhausted']}, mean_participation "
          f"{out['mean_participation']}")
    print(f"phase e (Algorithm 1, event_driven, cellular-flaky): {wall:.1f} s")


def run_coupled_path() -> None:
    """Phase f: Algorithm 1 on semi_async over cellular-flaky with the
    correlated-skew scenario at rho 1 (dirichlet split), counters reset just
    before: each fused-round kernel once a round; the summary's spearman
    and the run's permutation are make_scenario's on the host."""
    from repro_torch import sim
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    label = f"train {' '.join(COUPLED_ARGS)}"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main(COUPLED_ARGS)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    report_rounds(out, label, wall, launches, ROUNDS)
    expect_launches(label, launches, {"center_sq_dists": ROUNDS,
                                      "fused_coalition_stats": ROUNDS})
    args = train.build_parser().parse_args(COUPLED_ARGS)
    data = synthetic.mnist_idx()
    ytr = (data[0][1] if data is not None
           else synthetic.digits(args.n_train, seed=0)[1])
    meta = sim.make_scenario(args.scenario, ytr, args.clients,
                             fleet=args.fleet, regime=args.regime,
                             rho=args.rho, seed=args.seed,
                             sim_seed=args.sim_seed).metadata
    got = out["scenario_metadata"]
    print(f"{label}: scenario_spearman {out['scenario_spearman']} (host "
          f"{round(meta['spearman'], 4)}), permutation {got['permutation']} "
          f"(host {meta['permutation']}), participation "
          f"{out['history'].participation}, sim_time_s "
          f"{out['sim_time_s']}, wan_MB {out['wan_MB']}")
    if (out["scenario_spearman"] != round(meta["spearman"], 4)
            or got["permutation"] != meta["permutation"]):
        fail(f"{label}: the run's scenario is not make_scenario's")
    print(f"phase f (correlated-skew, rho 1, semi_async): {wall:.1f} s")


def run_cohort_path() -> None:
    """Phase g: cohort mode over a fleet of FLEET_SIZE devices on scan,
    counters reset just before: each fused-round kernel once a round; every
    schedule row distinct ids of positive effective availability.  Then the
    sampler alone: its time for the run's schedule on the card, and
    sample_cohort at N = FLEET_SIZE on the card and the CPU from the same
    Gumbel row (identical ids; hierarchical equal to flat)."""
    import numpy as np
    import torch

    from repro_torch import sim
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    label = f"train {' '.join(COHORT_ARGS)}"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main(COHORT_ARGS)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    report_rounds(out, label, wall, launches, ROUNDS)
    expect_launches(label, launches, {"center_sq_dists": ROUNDS,
                                      "fused_coalition_stats": ROUNDS})
    args = train.build_parser().parse_args(COHORT_ARGS)
    fleet = sim.make_fleet(args.fleet, FLEET_SIZE, seed=args.sim_seed)
    p = sim.effective_p(fleet, args.participation)
    cohorts = out["history"].cohorts
    print(f"{label}: cohorts {cohorts}, fleet_size {out['fleet_size']}, "
          f"cohort_size {out['cohort_size']}")
    for row in cohorts:
        if len(set(row)) != args.clients or not bool(torch.all(p[row] > 0)):
            fail(f"{label}: cohort {row} is not {args.clients} distinct "
                 f"available devices")
    w = p.cuda()
    gumbel = sim.cohort.gumbel_rows(ROUNDS, FLEET_SIZE,
                                    torch.Generator().manual_seed(0))
    for _ in range(2):                     # the second call is timed
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sched = sim.sample_cohorts(w, ROUNDS, args.clients,
                                   generator=torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        sim.sample_cohorts(w, ROUNDS, args.clients, gumbel=gumbel)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    print(f"phase g: the ({ROUNDS}, {args.clients}) schedule over "
          f"N = {FLEET_SIZE}: {1e3 * (t2 - t1):.3f} ms with its Gumbel rows "
          f"drawn on the host, {1e3 * (t3 - t2):.3f} ms from given rows "
          f"(moved to the card and two top-k levels a row)")
    card = sim.sample_cohort(w, args.clients, gumbel[0])
    cpu = sim.sample_cohort(p, args.clients, gumbel[0])
    flat = sim.sample_cohort(w, args.clients, gumbel[0],
                             cell_size=FLEET_SIZE)
    print(f"phase g: sample_cohort at N = {FLEET_SIZE}, cell "
          f"{sim.DEFAULT_CELL}: card {card.tolist()}, CPU {cpu.tolist()}, "
          f"flat {flat.tolist()}; schedule row 0 {sched[0].tolist()}")
    if not (torch.equal(card.cpu(), cpu) and torch.equal(flat, card)):
        fail("phase g: the card's cohort is not the CPU's or flat top-k's")
    if len(set(card.tolist())) != args.clients or not np.all(
            p.numpy()[card.cpu().numpy()] > 0):
        fail("phase g: sample_cohort gave repeated or unavailable devices")
    print(f"phase g (cohort mode, N = {FLEET_SIZE}): {wall:.1f} s")


def run_attack_path() -> None:
    """Phase h: sign_flip on 20% of the fleet on scan, counters reset just
    before: each fused-round kernel once a round; the adversaries are
    adversary_mask's on the host table; quarantine in [0, 1] and
    contamination finite and >= 0 every round.  Then one local phase on the
    card (the main path's clients, data and epochs) through the DP path at
    clip 1.0: at sigma 0 every delta norm is within the clip, at sigma
    DP_SIGMA the residual's std is within DP_STD_RTOL of DP_SIGMA."""
    import numpy as np
    import torch

    from repro_torch import sim
    from repro_torch.core import client, pytree
    from repro_torch.data import loader, partition, synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import zoo

    label = f"train {' '.join(ATTACK_ARGS)}"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main(ATTACK_ARGS)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    report_rounds(out, label, wall, launches, ROUNDS)
    expect_launches(label, launches, {"center_sq_dists": ROUNDS,
                                      "fused_coalition_stats": ROUNDS})
    args = train.build_parser().parse_args(ATTACK_ARGS)
    mask = sim.adversary_mask(
        sim.make_fleet(args.fleet, args.clients, seed=args.sim_seed),
        args.adv_frac, args.rho_adv, seed=args.sim_seed)
    hist = out["history"]
    print(f"{label}: n_adversaries {out['n_adversaries']} (host mask "
          f"{mask.astype(int).tolist()}), quarantine {hist.quarantine}, "
          f"contamination {hist.contamination}, assignments "
          f"{hist.assignments}")
    if out["n_adversaries"] != 2 or any(
            row != mask.astype(int).tolist() for row in hist.adversary):
        fail(f"{label}: the adversaries are not adversary_mask's")
    for q, c in zip(hist.quarantine, hist.contamination):
        if not (0.0 <= q <= 1.0 and math.isfinite(c) and c >= 0.0):
            fail(f"{label}: quarantine {q} or contamination {c} out of "
                 f"range")
    print(f"phase h (sign_flip, adv_frac 0.2): {wall:.1f} s")

    model = zoo.make_model("cnn")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device="cuda")
    x, y = synthetic.digits(args.n_train, seed=0)
    cd = {k: torch.from_numpy(v).cuda() for k, v in loader.client_datasets(
        x, y, partition.partition(args.regime, y, args.clients,
                                  seed=0)).items()}
    n_local = cd["y"].shape[1]
    perms = torch.argsort(torch.rand(
        (args.clients, args.local_epochs, n_local), generator=gen),
        dim=-1).cuda()
    t1 = time.perf_counter()
    stacked, _ = client.local_phase(
        model.loss_fn, params, cd, perms,
        client.ClientConfig(epochs=args.local_epochs,
                            batch_size=args.batch_size, lr=args.lr))
    w = pytree.client_matrix(stacked, model.layout)
    theta = pytree.flatten(params, model.layout)
    clipped = client.privatize(w, theta, client.ClientConfig(dp_clip=1.0))
    noised = client.privatize(
        w, theta, client.ClientConfig(dp_clip=1.0, dp_sigma=DP_SIGMA),
        generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    raw = torch.linalg.vector_norm(w - theta, dim=1)
    norms = torch.linalg.vector_norm(clipped - theta, dim=1)
    std = float(torch.std(noised - clipped))
    dp_s = time.perf_counter() - t1
    print(f"phase h DP: one local phase ({args.local_epochs} epochs, "
          f"{args.clients} clients, D = {w.shape[1]}) and the DP path in "
          f"{dp_s:.2f} s; delta norms {[round(float(v), 4) for v in raw]} -> "
          f"{[round(float(v), 6) for v in norms]} at clip 1.0; residual std "
          f"at sigma {DP_SIGMA}: {std:.6f}")
    if not bool(torch.all(norms <= 1.0 * (1 + 1e-6))):
        fail("phase h: a clipped delta norm exceeds the clip")
    if not abs(std / DP_SIGMA - 1.0) <= DP_STD_RTOL:
        fail(f"phase h: noise std {std} is not within {DP_STD_RTOL:.0%} of "
             f"{DP_SIGMA}")


class timing:
    """Within the block, every call of ``owner.name`` appends its seconds
    to ``times`` (a method, or a module's function)."""

    def __init__(self, owner, name: str, times: list):
        self.owner, self.name, self.times = owner, name, times

    def __enter__(self):
        original = self.original = getattr(self.owner, self.name)
        times = self.times

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = original(*args, **kw)
            times.append(time.perf_counter() - t0)
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.original)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def run_host_path(tmp: str) -> dict:
    """Phase i: the main path on semi_async over the ideal fleet with every
    host-side hook, counters reset just before: a snapshot and a checkpoint
    each round, the ledger and its trace; each fused kernel once a round
    and nothing else; the store keeps the newest HOST_KEEP rounds; the
    ledger is run_meta plus a record a round and its trace validates.  Then
    :func:`resume_check` in a process of its own: the resume launches each
    fused kernel once and equals the uninterrupted run bit for bit.
    Returns the store's path and the figures."""
    from repro_torch import checkpoint
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.obs import timeline
    from repro_torch.serve import ModelStore

    store, ckpt = os.path.join(tmp, "store"), os.path.join(tmp, "ckpt")
    ledger, trace = os.path.join(tmp, "run.jsonl"), os.path.join(
        tmp, "trace.json")
    argv = HOST_FLAGS + [
        "--snapshot-dir", store, "--snapshot-every", "1", "--snapshot-keep",
        str(HOST_KEEP), "--ckpt-dir", ckpt, "--ckpt-every", "1",
        "--metrics-out", ledger, "--trace-out", trace]
    label = (f"train {' '.join(HOST_FLAGS)} --snapshot-every 1 "
             f"--snapshot-keep {HOST_KEEP} --ckpt-every 1 (+ ledger, trace)")
    publish_s, save_s = [], []
    with timing(ModelStore, "publish", publish_s), \
            timing(checkpoint, "save_federation", save_s):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = train.main(argv)
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    report_rounds(out, label, wall, launches, ROUNDS)
    expect_launches(label, launches, {"center_sq_dists": ROUNDS,
                                      "fused_coalition_stats": ROUNDS})
    want_rounds = list(range(ROUNDS))
    if out["published_rounds"] != want_rounds[-HOST_KEEP:]:
        fail(f"{label}: the store kept {out['published_rounds']}, not the "
             f"newest {HOST_KEEP} of {want_rounds}")
    if out["ckpt_rounds"] != want_rounds:
        fail(f"{label}: checkpoints {out['ckpt_rounds']}")
    records = timeline.read_ledger(ledger)
    kinds = [r["kind"] for r in records]
    errors = timeline.validate_trace(timeline.build_trace(records))
    errors += timeline.validate_trace(json.load(open(trace)))
    if kinds != ["run_meta"] + ["round"] * ROUNDS or errors:
        fail(f"{label}: ledger {kinds}, trace errors {errors}")
    snap_bytes = dir_bytes(os.path.join(store, f"step_{ROUNDS - 1:08d}"))
    ckpt_bytes = dir_bytes(os.path.join(ckpt, f"step_{ROUNDS - 1:08d}"))
    print(f"{label}: snapshot writes {[round(t, 4) for t in publish_s]} s "
          f"({snap_bytes} bytes each), checkpoint writes "
          f"{[round(t, 4) for t in save_s]} s ({ckpt_bytes} bytes the "
          f"last), ledger {len(records)} records, trace "
          f"{out['trace_events']} events, errors {errors}")
    if len(publish_s) != ROUNDS or len(save_s) != ROUNDS:
        fail(f"{label}: {len(publish_s)} snapshots and {len(save_s)} "
             f"checkpoints, not {ROUNDS} each")
    print(f"phase i (host side, semi_async, ideal): {wall:.1f} s")

    label = (f"train {' '.join(RESUME_FLAGS)} --ckpt-every 1, cut to round "
             f"{ROUNDS - 2} and --resume (deterministic algorithms, a "
             f"process of its own)")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), RESUME_CHECK,
         os.path.join(tmp, "resume")], env=dict(os.environ,
                                                 **DETERMINISTIC_ENV),
        capture_output=True, text=True, timeout=900)
    if proc.returncode:
        fail(f"{label}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"{label}: resume {res['resume_s']:.2f} s ({res['restore_s']:.4f} "
          f"s of it the restore), launches {res['launches']}; theta against "
          f"the uninterrupted run's: max abs err / max {res['theta_err']:.3e}"
          f", every trace row {'equal' if res['rows'] else 'NOT equal'}; "
          f"test_acc {res['test_acc']} against {res['test_acc_full']}")
    expect_launches(label, res["launches"], {"center_sq_dists": 1,
                                             "fused_coalition_stats": 1})
    if not (res["theta_err"] == 0.0 and res["rows"]):
        fail(f"{label}: the resumed run is not the uninterrupted run's bit "
             f"for bit")
    return {"store": store, "publish_s": publish_s, "save_s": save_s,
            "restore_s": res["restore_s"], "resume_s": res["resume_s"],
            "snap_bytes": snap_bytes, "ckpt_bytes": ckpt_bytes}


def resume_check(tmp: str) -> None:
    """Phase i's resume, in a process of its own (``chip_smoke.py
    RESUME_CHECK DIR``, with DETERMINISTIC_ENV): under torch's deterministic
    algorithms the local phase is bit-reproducible on the card
    (scripts/determinism_cost.py; by default cuDNN's and the batch
    gather's gradients add in any order), so a run checkpointed every
    round, cut back to round ROUNDS - 2 and resumed must give the
    uninterrupted run's θ and trace rows bit for bit.  The resume's
    launches are counted with the counters at 0 just before it.  Prints
    one JSON line."""
    import torch

    from repro_torch.core import pytree
    from repro_torch.core.server import TIMING_FIELDS, Federation
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import zoo

    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    ckpt, cut = os.path.join(tmp, "ckpt"), os.path.join(tmp, "cut")
    full = train.main(RESUME_FLAGS + ["--ckpt-dir", ckpt, "--ckpt-every",
                                      "1"])
    shutil.copytree(ckpt, cut)
    shutil.rmtree(os.path.join(cut, f"step_{ROUNDS - 1:08d}"))
    restore_s = []
    with timing(Federation, "_restore_ckpt", restore_s):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = train.main(RESUME_FLAGS + ["--ckpt-dir", cut,
                                         "--ckpt-every", "1", "--resume"])
        resume_s = time.perf_counter() - t0
        launches = ops.launch_counts()
    layout = zoo.make_model("cnn").layout
    _, theta_err = rel_err(pytree.flatten(res["params"], layout),
                           pytree.flatten(full["params"], layout))
    h, h_res = full["history"].trace, res["history"].trace
    rows = all(getattr(h, f) is None
               or (getattr(h, f) == getattr(h_res, f)).all()
               for f in h._fields if f not in TIMING_FIELDS)
    print(json.dumps({"launches": launches, "theta_err": theta_err,
                      "rows": bool(rows), "restore_s": restore_s[0],
                      "resume_s": resume_s, "test_acc": res["test_acc"],
                      "test_acc_full": full["test_acc"]}))


def run_serve_fl_path(store_dir: str) -> dict:
    """Phase ii: ``serve --mode fl`` on phase i's store at the CLI's
    defaults, counters reset just before (no kernel launches), with a round
    published after its first batch: at least one hot swap, one capture in
    all; then a steady-state run, and the routed logits of every client and
    a stranger against a direct forward through its coalition's barycenter
    or θ, within SERVE_FL_TOL of the max."""
    import numpy as np
    import torch

    from repro_torch.core import pytree
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import cnn
    from repro_torch.serve import BatchServer, ModelStore

    publisher = ModelStore(store_dir, keep=HOST_KEEP)
    published = []
    original = BatchServer.serve

    def serve_then_publish(self, ids, x):
        out = original(self, ids, x)
        if not published:        # the trainer publishes a newer round
            snap = publisher.load()
            r = snap.round + 1
            noise = torch.randn(snap.barycenters.shape,
                                generator=torch.Generator().manual_seed(r))
            publisher.publish(
                r, snap.global_params, snap.barycenters + 0.01 * noise,
                assignment=np.roll(snap.assignment, 1), counts=snap.counts,
                extra_meta={k: snap.meta[k] for k in ("engine", "method",
                                                      "n_clients")})
            published.append(r)
        return out

    argv = ["--mode", "fl", "--store-dir", store_dir]
    label = "serve --mode fl (defaults, a round published after batch 0)"
    BatchServer.serve = serve_then_publish
    try:
        ops.reset_launch_counts()
        out = serve.main(argv)
        launches = ops.launch_counts()
    finally:
        BatchServer.serve = original
    expect_launches(label, launches, {})
    print(f"{label}: queries_per_s {out['queries_per_s']}, swap_ms_mean "
          f"{out['swap_ms_mean']}, hot_swaps {out['hot_swaps']}, "
          f"compile_count {out['compile_count']}, round {out['round']}")
    if (out["hot_swaps"] < 1 or out["compile_count"] != 1
            or out["round"] != published[0]):
        fail(f"{label}: no hot swap to round {published}, or the swap "
             f"rebuilt the program")
    steady = serve.main(argv + SERVE_FL_STEADY)
    print(f"serve --mode fl {' '.join(SERVE_FL_STEADY)}: queries_per_s "
          f"{steady['queries_per_s']}, compile_count "
          f"{steady['compile_count']}")

    snap = ModelStore(store_dir).load(device="cuda")
    server = BatchServer(cnn.apply, cnn.REF_LAYOUT, snap, device="cuda")
    ids = np.array(list(range(snap.assignment.size)) + [-1])
    x = torch.randn((ids.size, 28, 28, 1), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    got = server.serve(ids, x)
    params = pytree.from_ref_tree(snap.global_params, cnn.REF_LAYOUT)
    worst = 0.0
    with torch.no_grad():
        for q, row in enumerate(server.routing.model_rows(ids)):
            vec = (pytree.flatten(params, cnn.REF_LAYOUT) if row == 0
                   else snap.barycenters[row - 1])
            want = cnn.apply(pytree.unflatten(vec, cnn.REF_LAYOUT, params),
                             x)[q]
            worst = max(worst, rel_err(got[q], want)[1])
    print(f"serve --mode fl routed logits against a direct forward through "
          f"each row's model: max abs err / max {worst:.3e} (bound "
          f"{SERVE_FL_TOL:.0e})")
    if not worst <= SERVE_FL_TOL:
        fail("serve --mode fl: routed logits disagree with a direct forward")
    return {"qps": out["queries_per_s"], "swap_ms": out["swap_ms_mean"],
            "steady_qps": steady["queries_per_s"]}


def run_tiny_path() -> dict:
    """Phase iii: ``train --mode fl --model transformer_tiny`` for ROUNDS
    rounds, counters reset just before: each fused kernel once a round on
    the bf16 (10, 27,626) W, nothing else; accuracy finite; the last round
    on cuda against the same W and state on stream (equal assignment and
    centers, θ within TOL of its max).  Then both fused kernels at this
    shape against their plain versions, and timed.  Returns the kernels'
    rows for the kernels line."""
    import torch

    from repro_torch.core import strategies
    from repro_torch.kernels import fused_round as fr
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train

    seen = {}
    original = strategies.CoalitionStrategy.round

    def recording(self, w, state, mask=None):
        res = original(self, w, state, mask)
        seen.update(w=w, state=state, mask=mask, res=res,
                    route=fr.route(*w.shape[:1], self.n_groups, w.shape[1],
                                   w.dtype, w.data_ptr()))
        return res

    label = f"train {' '.join(TINY_ARGS)}"
    strategies.CoalitionStrategy.round = recording
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = train.main(TINY_ARGS)
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        strategies.CoalitionStrategy.round = original
    for r, (loc, srv) in enumerate(zip(out["local_s"], out["server_s"])):
        print(f"{label} round {r}: local phase {loc:.4f} s, server step "
              f"{srv:.4f} s")
    w = seen["w"]
    print(f"{label}: {wall:.1f} s, launches {launches}, W {tuple(w.shape)} "
          f"{w.dtype} (route {seen['route']}), test_acc {out['test_acc']}")
    expect_launches(label, launches, {"center_sq_dists": ROUNDS,
                                      "fused_coalition_stats": ROUNDS})
    if tuple(w.shape) != TINY[::2] or w.dtype != torch.bfloat16:
        fail(f"{label}: W is {tuple(w.shape)} {w.dtype}, not a bf16 "
             f"{TINY[::2]}")
    if not all(math.isfinite(a) for a in out["test_acc"]):
        fail(f"{label}: accuracy {out['test_acc']} is not finite")
    stream = strategies.make_strategy("coalition", n_clients=TINY[0],
                                      n_coalitions=TINY[1],
                                      backend="stream")
    want, got = stream.round(w, seen["state"], mask=seen["mask"]), \
        seen["res"]
    _, theta_err = rel_err(got.theta, want.theta)
    print(f"{label}: the last round on cuda against stream: assignment "
          f"{got.metrics.assignment.tolist()} / "
          f"{want.metrics.assignment.tolist()}, centers "
          f"{got.state.center_idx.tolist()} / "
          f"{want.state.center_idx.tolist()}, theta max abs err / max "
          f"{theta_err:.3e}")
    if (not torch.equal(got.metrics.assignment, want.metrics.assignment)
            or not torch.equal(got.state.center_idx, want.state.center_idx)
            or not theta_err <= TOL):
        fail(f"{label}: the cuda round is not stream's")
    print(f"phase iii (transformer_tiny, bf16 W): {wall:.1f} s")

    n, k, d = TINY
    w, conehot, m = inputs(n, k, d, torch.bfloat16, seed=3)
    errs = {"center_sq_dists": rel_err(fr.center_sq_dists(w, conehot),
                                       ref.center_sq_dists(w, conehot))}
    pairs = [rel_err(g, r) for g, r in zip(fr.fused_coalition_stats(w, m),
                                          ref.fused_coalition_stats(w, m))]
    errs["fused_coalition_stats"] = (max(a for a, _ in pairs),
                                     max(r for _, r in pairs))
    for name, (err, rel) in errs.items():
        print(f"check {name} N={n} K={k} D={d} bfloat16 (route "
              f"{fr.route(n, k, d, w.dtype, w.data_ptr())}): max abs err "
              f"{err:.3e}, / max {rel:.3e} (bound {TOL:.0e})")
        if not rel <= TOL:
            fail(f"{name} disagrees with its plain version at the "
                 f"transformer_tiny shape")
    wb = n * d * 2
    # the library yardstick takes f32: its upcast of W is in the timed call
    centers = conehot @ w.float()
    rows = {
        "center_sq_dists": timed_row(
            f"center_sq_dists N={n} K={k} D={d} bf16",
            lambda: fr.center_sq_dists(w, conehot),
            lambda: ref.center_sq_dists(w, conehot),
            lambda: torch.cdist(w.float(), centers),
            wb + 4 * (k * n + n * k), 2 * k * n * d + 3 * n * k * d),
        "fused_coalition_stats": timed_row(
            f"fused_coalition_stats N={n} K={k} D={d} bf16",
            lambda: fr.fused_coalition_stats(w, m),
            lambda: ref.fused_coalition_stats(w, m), None,
            wb + 4 * (k * n + k * d + d + n * k),
            2 * k * n * d + k * d + d + 3 * n * k * d)}
    for name, row in rows.items():
        row["err"] = errs[name][0]
        row["kernel_route"] = fr.route(n, k, d, w.dtype, w.data_ptr())
    rows["launches"] = launches
    return rows


def run_sketch_path():
    """Phase 7: the sketch path through the training entry point, counters
    reset just before: sq_dists_to_points twice and segment_sum once per
    server step.  Returns the routes of its launches (see
    :func:`path_run`) and the run's last client matrix (recorded by
    wrapping ``pytree.client_matrix`` for the run)."""
    from repro_torch.core import pytree
    from repro_torch.launch import train

    made = []
    client_matrix = pytree.client_matrix

    def recording(*args, **kw):
        made[:] = [client_matrix(*args, **kw)]
        return made[0]

    pytree.client_matrix = recording
    try:
        t0 = time.perf_counter()
        out, launches, routes = path_run(lambda: train.main(
            [*SKETCH_ARGS, "--rounds", str(SKETCH_ROUNDS)]))
        wall = time.perf_counter() - t0
    finally:
        pytree.client_matrix = client_matrix
    label = f"train {' '.join(SKETCH_ARGS)} --rounds {SKETCH_ROUNDS}"
    report_rounds(out, label, wall, launches, SKETCH_ROUNDS)
    print(f"{label}: launches by (kernel, route, D) {dict(routes)}")
    expect_launches(label, launches,
                    {"sq_dists_to_points": 2 * SKETCH_ROUNDS,
                     "segment_sum": SKETCH_ROUNDS})
    if out["sketch"] != "rproj" or out["method"] != "coalition_topk":
        fail(f"{label}: the summary reports sketch {out['sketch']!r}, "
             f"method {out['method']!r}")
    return routes, made[0]


def run_pairwise(w) -> tuple[dict, float]:
    """Phase 7, last: distance.pairwise_sq_dists on the sketch run's client
    matrix through the cuda backend, counters reset just before; held to
    the plain version.  Returns the routes of its launches (see
    :func:`path_run`) and the max abs error."""
    import torch

    from repro_torch.core import distance
    from repro_torch.kernels import ref

    def pairwise():
        got = distance.pairwise_sq_dists(w, backend="cuda")
        torch.cuda.synchronize()
        return got
    got, launches, routes = path_run(pairwise)
    err, rel = rel_err(got, ref.pairwise_sq_dists(w))
    print(f"pairwise_sq_dists on the run's client matrix {tuple(w.shape)}: "
          f"max abs err {err:.3e}, / max {rel:.3e}, launches {launches}, by "
          f"(kernel, route, D) {dict(routes)}")
    expect_launches("pairwise_sq_dists on the run's client matrix", launches,
                    {"pairwise_sq_dists": 1})
    if not (rel <= TOL and torch.all(torch.diagonal(got) == 0)
            and torch.equal(got, got.T)):
        fail("pairwise_sq_dists on the run's client matrix disagrees with "
             "its plain version, is not symmetric or has a diagonal that is "
             "not exactly 0")
    return routes, err


def run_pretrain_path() -> dict:
    """The pretrain path through the training entry point, counters reset
    just before: hymba-1.5b in full with --flash, PRETRAIN_STEPS steps of
    Adam.  flash_attention must launch once per attention layer per step
    and no other kernel at all; every loss finite and the last below the
    first.  Prints seconds per step, tokens/s and the peak memory; returns
    the launches."""
    import torch

    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    cfg = get("hymba-1.5b")
    label = f"train {' '.join(PRETRAIN_ARGS)}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main(PRETRAIN_ARGS)       # raises if the loss did not fall
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, step_s = out["losses"], out["step_s"]
    args = train.build_parser().parse_args(PRETRAIN_ARGS)
    tokens = args.batch_size * (args.seq_len + 1)
    steady = step_s[1:] or step_s
    per_step = sum(steady) / len(steady)
    print(f"{label}: {wall:.1f} s, step seconds {[round(t, 4) for t in step_s]}"
          f", {per_step:.4f} s/step after the first ({tokens / per_step:.0f} "
          f"tokens/s), peak memory {peak / 2**30:.2f} GiB, launches "
          f"{launches}, losses {losses}")
    expect_launches(label, launches,
                    {"flash_attention": cfg.n_layers * PRETRAIN_STEPS})
    if not (all(math.isfinite(x) for x in losses)
            and len(losses) == PRETRAIN_STEPS and losses[-1] < losses[0]):
        fail(f"{label}: losses {losses} are not finite or do not fall")
    return launches


def full_model():
    """hymba-1.5b in full on the card (seed 0) and one batch of the pretrain
    path's tokens (10 x 129)."""
    import torch

    from repro_torch.configs import get
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as tf

    cfg = get("hymba-1.5b")
    model = tf.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                    device="cuda")
    return model, {"tokens": torch.from_numpy(synthetic.lm_tokens(
        10, 129, cfg.vocab, seed=0)).cuda()}


def check_forward(model, batch) -> None:
    """One forward of the full model with the flash kernel and with the
    plain attention: the losses must agree within FORWARD_RTOL (the
    reference's test_model_forward_with_flash_kernel_matches_xla at full
    size)."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models import transformer as tf

    losses = {}
    with torch.no_grad():
        for flash in (True, False):
            layers.set_flash_kernel(flash)
            losses[flash] = float(tf.loss_fn(model, batch))
    layers.set_flash_kernel(False)
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    print(f"forward {model.cfg.name} {tuple(batch['tokens'].shape)}: loss "
          f"with the kernel {losses[True]:.6f}, plain {losses[False]:.6f}, "
          f"rel diff {rel:.3e} (bound {FORWARD_RTOL:.0e})")
    if not rel <= FORWARD_RTOL:
        fail("the full model's loss with the flash kernel disagrees with "
             "the plain attention's")


def profile_pretrain_step(model, batch) -> None:
    """Where a pretrain step's time goes: the pretrain path's own step (the
    full model with the flash kernel, Adam at PRETRAIN_LR, remat off as the
    pretrain CLI runs it); one warm-up step, one step timed plain,
    one traced with torch.profiler: the device's busy share and its top
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps
    from repro_torch.models import layers

    layers.set_flash_kernel(True)
    step_fn, opt = steps.make_train_step(model.cfg, optimizer="adam",
                                         lr=float(PRETRAIN_LR), remat=False)
    state = opt.init(dict(model.named_parameters()))

    def one_step():
        step_fn(model, state, batch)
        torch.cuda.synchronize()

    one_step()                                       # warm-up
    t0 = time.perf_counter()
    one_step()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_step()
    layers.set_flash_kernel(False)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    print(f"profile pretrain step: {wall:.4f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f}% of the step), {launches} device "
          f"kernels")
    for e in kernels[:8] + [e for e in kernels[8:] if "flash" in e.key]:
        print(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:70]}")


def with_config(model, **changes) -> None:
    """Replace fields of a model's config and of every block's (each module
    keeps its own reference to its config)."""
    import dataclasses

    for module in model.modules():
        if "cfg" in vars(module):
            module.cfg = dataclasses.replace(module.cfg, **changes)


def decode_bytes(model, batch: int, cache_len: int) -> int:
    """The bytes one decode step must read once: the parameters it touches
    (the decoder's blocks, the final norm and the head; not the encoder,
    whose memory is cached, nor a VLM's projector, whose prefix is cached,
    nor an untied embedding table, of which it gathers B rows) and the
    whole cache (K/V timelines, SSM state, encoder memory)."""
    from repro_torch.models import transformer as tf

    cfg = model.cfg
    total = 0
    for name, p in model.named_parameters():
        if (name.startswith("encoder.") or name == "proj"
                or (name == "embed" and not cfg.tie_embeddings)):
            continue
        total += p.numel() * p.element_size()
    cache = tf.init_cache(cfg, batch, cache_len, device="meta")
    return total + sum(t.numel() * t.element_size() for t in cache.values())


def last_logits(model, batch: dict):
    """The full forward's last logits in f32."""
    import torch

    from repro_torch.models import transformer as tf

    with torch.no_grad():
        return tf.forward(model, batch)[0][:, -1].float()


def profile_decode(model, batch: dict, flash: bool) -> dict:
    """Where a decode step's time goes: prefill the phase's batch, one
    decode step as warm-up, then DECODE_TRACED steps traced with
    torch.profiler: the device's busy share, its kernels a token and the
    top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import layers
    from repro_torch.models import transformer as tf

    cfg = model.cfg
    tokens = batch["tokens"]
    prefix = cfg.n_modal_tokens if (cfg.modality and not cfg.enc_dec) else 0
    layers.set_flash_kernel(flash)
    try:
        with torch.no_grad():
            cache = tf.init_cache(cfg, tokens.shape[0],
                                  prefix + tokens.shape[1] + 1 + DECODE_TRACED,
                                  device=tokens.device)
            logits, cache = tf.prefill(model, batch, cache)
            tok = logits.argmax(-1)
            logits, cache = tf.decode_step(model, tok, cache)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(DECODE_TRACED):
                    logits, cache = tf.decode_step(model, logits.argmax(-1),
                                                   cache)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        layers.set_flash_kernel(False)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels) / DECODE_TRACED
    print(f"profile serve {cfg.name} decode: {DECODE_TRACED} steps in "
          f"{wall:.4f} s traced, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f}%), {launches:.0f} device kernels a "
          f"token")
    for e in kernels[:5]:
        print(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:70]}")
    return {"busy": busy / wall, "kernels": launches}


def check_decode(model, batch: dict, flash: bool) -> float:
    """Gate (c): prefill S - 1 tokens (after any modal prefix) and one
    decode step against the full forward's last logits, in the model's
    dtype with a cache of that dtype, with the flash switch as the phase
    served (MoE at capacity SERVE_CHECK_CF, then put back).  Prints beside
    it the same forward run one row at a time against the batched one (the
    floor that bf16 rounding alone sets).  Returns the max abs error over
    max |logit|; fails above SERVE_RTOL for the dtype or on a non-finite
    logit."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models import transformer as tf

    cfg = model.cfg
    tokens = batch["tokens"]
    b, s = tokens.shape
    prefix = cfg.n_modal_tokens if (cfg.modality and not cfg.enc_dec) else 0
    if cfg.moe:
        with_config(model, capacity_factor=SERVE_CHECK_CF)
    layers.set_flash_kernel(flash)
    try:
        last = last_logits(model, batch)
        rows = torch.cat([last_logits(model, {k: v[i:i + 1]
                                              for k, v in batch.items()})
                          for i in range(b)])
        with torch.no_grad():
            cache = tf.init_cache(cfg, b, prefix + s + 1,
                                  device=tokens.device)
            _, cache = tf.prefill(model, {**batch, "tokens": tokens[:, :-1]},
                                  cache)
            step = tf.decode_step(model, tokens[:, -1], cache)[0].float()
    finally:
        layers.set_flash_kernel(False)
        if cfg.moe:
            with_config(model, capacity_factor=cfg.capacity_factor)
    bound = SERVE_RTOL[cfg.dtype]
    _, ratio = rel_err(step, last)
    _, floor = rel_err(rows, last)
    finite = bool(torch.isfinite(last).all() and torch.isfinite(step).all())
    print(f"serve {cfg.name}: decode against forward, {cfg.dtype}, "
          f"{cfg.n_layers} layers (prefill {s - 1} + 1 decode"
          f"{f', capacity {SERVE_CHECK_CF}' if cfg.moe else ''}): max abs err "
          f"/ max |logit| {ratio:.4e} (bound {bound:.0e}); the forward one "
          f"row at a time against batched {floor:.4e}; argmax equal "
          f"{bool(torch.equal(step.argmax(-1), last.argmax(-1)))}")
    if not (finite and ratio <= bound):
        fail(f"serve {cfg.name}: decode disagrees with the full forward in "
             f"{cfg.dtype} or is not finite")
    return ratio


def check_decode_f32(model, batch: dict, flash: bool) -> float:
    """Gate (c) in f32: the served model's leading layers that fit in
    SERVE_F32_BYTES of f32 (the later ones dropped first), cast to f32 in
    place, through :func:`check_decode` with an f32 cache.  The model is
    left in f32: only :func:`check_encoder_flash` uses it after this."""
    cfg = model.cfg
    per_layer = 4 * sum(p.numel() for p in model.layers[0].parameters())
    rest = 4 * sum(p.numel() for name, p in model.named_parameters()
                   if not name.startswith("layers."))
    keep = min(cfg.n_layers, int((SERVE_F32_BYTES - rest) // per_layer))
    del model.layers[keep:]
    with_config(model, n_layers=keep, dtype="float32")
    model.float()
    return check_decode(model, batch, flash)


def check_encoder_flash(model, batch: dict) -> dict:
    """Gate (d): the encoder-decoder's encoder memory and prefill logits
    through the flash kernel against the plain attention's, each within
    SERVE_RTOL of its max for the model's dtype.  Prints beside them the
    library's F.scaled_dot_product_attention in the kernel's place (set
    into ``ops`` for the call only): its own distance from the plain
    attention.  Returns the kernel's two ratios."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.models import encdec, layers
    from repro_torch.models import transformer as tf

    def library(q, k, v, *, causal, window, scale):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              scale=scale, enable_gqa=True)

    cfg = model.cfg
    b, s = batch["tokens"].shape
    kernel = ops.flash_attention
    runs = {}
    try:
        with torch.no_grad():
            for how in ("kernel", "plain", "library"):
                layers.set_flash_kernel(how != "plain")
                ops.flash_attention = library if how == "library" else kernel
                cache = tf.init_cache(cfg, b, s + 1,
                                      device=batch["tokens"].device)
                runs[how] = (encdec.encode(model, batch["modal"]).float(),
                             tf.prefill(model, batch, cache)[0].float())
    finally:
        ops.flash_attention = kernel
        layers.set_flash_kernel(False)
    bound = SERVE_RTOL[cfg.dtype]
    ratios = {}
    for i, label in enumerate(("memory", "prefill logits")):
        _, rel = rel_err(runs["kernel"][i], runs["plain"][i])
        _, lib = rel_err(runs["library"][i], runs["plain"][i])
        ratios[label] = rel
        print(f"serve {cfg.name}: {label} through the kernel against the "
              f"plain attention, {cfg.dtype}: max abs err / max {rel:.4e} "
              f"(bound {bound:.0e}); the library's SDPA in its place "
              f"{lib:.4e}")
        if not (rel <= bound and torch.isfinite(runs["kernel"][i]).all()):
            fail(f"serve {cfg.name}: the {label} through the flash kernel "
                 f"disagree with the plain attention's in {cfg.dtype}")
    return ratios


def run_serve_phase(arch: str, extra) -> dict:
    """A serve phase: ``serve --mode lm --full --arch A`` through the
    serving entry point, the counters set to 0 just before and the peak
    memory counted from there.  Gates: (a) tokens in the vocabulary and
    every logit finite; (b) flash_attention once per encoder layer under
    --flash (the encoder-decoder's prefill), no kernel otherwise; (c) decode
    against forward; (d) for the encoder-decoder, the kernel against the
    plain attention; (c) and (d) in bf16 as served, then again with the
    served weights cast to f32 (an f32 cache).  Prints the card, the
    times, the peak memory, the launches, the first tokens and the decode
    step's byte bound, and traces a few decode steps; frees the model.
    Returns the phase's figures."""
    import gc

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    argv = ["--mode", "lm", "--full", "--arch", arch, *extra]
    args = serve.build_parser().parse_args(argv)
    label = f"serve {' '.join(argv)}"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.main(argv)            # raises on a non-finite logit
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    model, batch, tokens = out["model"], out["batch"], out["tokens"]
    cfg = model.cfg
    if not (out["logits_finite"] and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab):
        fail(f"{label}: tokens outside the vocabulary or non-finite logits")
    expect_launches(label, launches, {"flash_attention": cfg.n_enc_layers}
                    if args.flash else {})
    prefix = cfg.n_modal_tokens if (cfg.modality and not cfg.enc_dec) else 0
    cache_len = prefix + args.prompt_len + args.gen
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    nbytes = decode_bytes(model, args.batch, cache_len)
    bound_ms = nbytes / PEAK_BYTES * 1e3
    print(card_line())
    print(f"{label}: {wall:.1f} s with the init; {cfg.n_params():,} "
          f"parameters ({weights / 2**30:.2f} GiB); prefill_s "
          f"{out['prefill_s']!r}, decode_s_per_tok "
          f"{out['decode_s_per_tok']!r}; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}; first tokens {tokens[0].tolist()}; a "
          f"decode step reads {nbytes / 1e9:.3f} GB: bound {bound_ms:.4f} ms "
          f"a token ({100 * bound_ms / 1e3 / out['decode_s_per_tok']:.1f}% "
          f"of the measured)")
    trace = profile_decode(model, batch, args.flash)
    ratio = check_decode(model, batch, args.flash)
    if cfg.enc_dec:
        check_encoder_flash(model, batch)
    ratio_f32 = check_decode_f32(model, batch, args.flash)
    if cfg.enc_dec:
        check_encoder_flash(model, batch)
    result = {"arch": arch, "prefill_s": out["prefill_s"],
              "decode_s_per_tok": out["decode_s_per_tok"], "peak": peak,
              "decode_bytes": nbytes, "bound_ms": bound_ms,
              "decode_ratio": ratio, "decode_ratio_f32": ratio_f32,
              "launches": launches, **trace}
    del model, batch, tokens, out
    gc.collect()
    torch.cuda.empty_cache()
    return result


def event_ms(fn, reps: int = 5) -> float:
    """Median ms of ``fn`` on the card by CUDA events, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def framework_scale() -> dict:
    """Phase 8: sketched against exact geometry at D = 8M (as the reference's
    benchmarks/run.py bench_federation_sketch), sq_dists_to_points and the
    segment sum at that D, and the sketch builds at the main path's D and
    at 8M; the composed round at 8M, counters set to 0 just before, whose
    launches the two 8M rows of the kernels line count; pairwise_sq_dists
    through the cuda backend at 8M, the same, and its kernel timed there.
    Returns those rows by kernel name, each with its max abs error against
    the plain version and its route, and the routes of the composed round's
    and of the pairwise call's launches (see :func:`path_run`) under
    "routes" and "pairwise routes"."""
    import torch

    from repro_torch.core import backends, coalitions, distance, fused
    from repro_torch.core import instrument, sketch
    from repro_torch.kernels import fused_round as fr
    from repro_torch.kernels import pairwise_dist as pd
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_mean as sm

    n, k, d = MAIN[0], MAIN[1], BIG_D
    g = torch.Generator(device="cuda").manual_seed(0)
    owner = torch.arange(n, device="cuda") % k
    mu = torch.tensor([-4.0, 0.0, 4.0], device="cuda")[owner][:, None]
    w = mu + 0.5 * torch.randn((n, d), generator=g, device="cuda")
    ci = torch.tensor([0, 1, 2], device="cuda")
    be = backends.get_backend("cuda")
    b = fused.fused_round(w, ci, backend=be).barycenters   # outside timing
    centers = w[ci]                                        # outside timing

    def exact():
        d2c = be.sq_dists_to_points(w, centers)
        return fused.pin_assignment(d2c, ci), be.sq_dists_to_points(w, b)

    exact_ms = event_ms(exact)
    ex_assign = exact()[0]
    print(f"scale N={n} K={k} D={d}: exact geometry (two full-W "
          f"sq_dists_to_points) {exact_ms:.4f} ms; the gather of the centers "
          f"w[ci] apart {event_ms(lambda: w[ci]):.4f} ms")
    conehot = torch.nn.functional.one_hot(ci, n).float()
    m = torch.nn.functional.one_hot(ex_assign, k).T.float()
    m = (m / m.sum(1, keepdim=True)).contiguous()           # outside timing

    def passes():
        d2c = fr.center_sq_dists(w, conehot)
        return fused.pin_assignment(d2c, ci), fr.fused_coalition_stats(w, m)

    passes_ms = event_ms(passes)
    round_ms = event_ms(lambda: fused.fused_round(w, ci, backend=be))
    same = (torch.equal(passes()[0], ex_assign) and torch.equal(
        fused.fused_round(w, ci, backend=be).assignment, ex_assign))
    print(f"scale N={n} K={k} D={d}: exact geometry as the fused round's two "
          f"passes {passes_ms:.4f} ms ({exact_ms / passes_ms:.2f}x below the "
          f"two sq_dists_to_points); the whole fused round with its O(NK) "
          f"glue {round_ms:.4f} ms; assignment equal: {same}")
    if not same:
        fail(f"the fused round's assignment at D={d} differs from the two "
             f"sq_dists_to_points'")
    state = coalitions.CoalitionState(center_idx=ci, round=0)

    def composed_round():
        rc = coalitions.run_round(w, state, backend="cuda", fused=False)
        torch.cuda.synchronize()
        return rc
    rc, launches, routes = path_run(composed_round)
    label = f"composed round N={n} K={k} D={d}"
    print(f"{label}: launches by (kernel, route, D) {dict(routes)}, "
          f"assignment equal to the exact geometry's: "
          f"{torch.equal(rc.assignment, ex_assign)}")
    expect_launches(label, launches, {"sq_dists_to_points": 2,
                                      "segment_sum": 1})
    if not torch.equal(rc.assignment, ex_assign):
        fail(f"the {label}'s assignment differs from the exact geometry's")
    del rc
    time_fused_big(w, conehot, m)
    rows = {"routes": routes}
    err, rel = rel_err(pd.sq_dists_to_points(w, centers),
                       ref.sq_dists_to_points(w, centers))
    if not rel <= TOL:
        fail(f"sq_dists_to_points at D={d} disagrees with its plain version")
    route = pd.route(n, k, d, w.dtype, w.data_ptr(), centers.dtype,
                     centers.data_ptr())
    rows["sq_dists_to_points"] = timed_row(
        f"sq_dists_to_points N={n} K={k} D={d} f32 (route {route}, max abs "
        f"err {err:.3e})",
        lambda: pd.sq_dists_to_points(w, centers),
        lambda: ref.sq_dists_to_points(w, centers),
        lambda: torch.cdist(w, centers) ** 2,
        4 * (n * d + k * d + n * k), 3 * n * k * d, clean=True)
    rows["sq_dists_to_points"].update(err=err, kernel_route=route)
    agreement = {}
    for s in (64, 256, 1024):
        sk = sketch.make_sketcher("countsketch", dim=s)
        stage = lambda: fused.sketch_stage(be, sketch.sketch_matrix(sk, w), ci)
        ms = event_ms(stage)
        agreement[s] = float((stage()[0] == ex_assign).float().mean())
        with instrument.count_w_passes() as passes:
            fused.fused_round(w, ci, backend=be, sketcher=sk)
        print(f"scale S={s}: countsketch + sketch_stage {ms:.4f} ms, speedup "
              f"{exact_ms / ms:.2f}x, agreement {agreement[s]:.3f}, sketched "
              f"round W passes {passes()}")
        if passes() != 2:
            fail(f"the sketched round at S={s} made {passes()} W passes")
    if not agreement[1024] >= 0.95:
        fail(f"sketched assignment agreement {agreement[1024]} < 0.95 at "
             f"S=1024")
    mix = torch.nn.functional.one_hot(owner, k).T.float().contiguous()
    err, rel = rel_err(sm.segment_sum(mix, w), ref.segment_sum(mix, w))
    if not rel <= TOL:
        fail(f"segment_sum at D={d} disagrees with its plain version")
    route = sm.route(n, k, d, w.dtype, w.data_ptr())
    rows["segment_sum"] = timed_row(
        f"segment_sum K={k} N={n} D={d} f32 (route {route}, max abs err "
        f"{err:.3e})",
        lambda: sm.segment_sum(mix, w), lambda: ref.segment_sum(mix, w),
        lambda: mix @ w, 4 * (n * d + k * n + k * d), 2 * k * n * d,
        clean=True)
    rows["segment_sum"].update(err=err, kernel_route=route)

    def pairwise():
        got = distance.pairwise_sq_dists(w, backend="cuda")
        torch.cuda.synchronize()
        return got
    pw, pw_launches, rows["pairwise routes"] = path_run(pairwise)
    label = f"pairwise_sq_dists N={n} D={d}"
    expect_launches(label, pw_launches, {"pairwise_sq_dists": 1})
    err, rel = rel_err(pw, ref.pairwise_sq_dists(w))
    if not (rel <= TOL and torch.equal(pw, pw.T) and torch.all(pw >= 0)
            and torch.all(torch.diagonal(pw) == 0)):
        fail(f"{label} disagrees with its plain version, is not symmetric "
             f"or has a diagonal that is not exactly 0")
    route = pd.pairwise_route(n, d, w.dtype, w.data_ptr())
    rows["pairwise_sq_dists"] = timed_row(
        f"{label} f32 (route {route}, max abs err {err:.3e})",
        lambda: pd.pairwise_sq_dists(w), lambda: ref.pairwise_sq_dists(w),
        lambda: torch.cdist(w, w) ** 2, 4 * (n * d + n * n),
        3 * n * (n - 1) // 2 * d, clean=True)
    rows["pairwise_sq_dists"].update(err=err, kernel_route=route)
    del pw
    for dd in (MAIN[2], d):
        wd = w[:, :dd].contiguous()
        for name in ("rproj", "countsketch"):
            sk = sketch.make_sketcher(name, dim=SKETCH_DIM)
            t0 = time.perf_counter()
            sketch.sketch_matrix(sk, wd)
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3
            print(f"sketch build {name} S={SKETCH_DIM} D={dd}: "
                  f"{event_ms(lambda: sketch.sketch_matrix(sk, wd)):.4f} ms "
                  f"(first call {first:.1f} ms of host clock)")
    del w, wd, b, centers
    torch.cuda.empty_cache()
    return rows


def time_fused_big(w, conehot, m) -> None:
    """Phase 8: both fused-round kernels at the framework-scale D, L2
    flushed, beside their bounds, their plain versions and (pass 1)
    torch.cdist(w, centers); then w.sum() as the read floor."""
    import torch

    from repro_torch.kernels import fused_round as fr
    from repro_torch.kernels import ref

    (n, d), k = w.shape, conehot.shape[0]
    centers = (conehot @ w).contiguous()
    wb = n * d * 4
    route = fr.route(n, k, d, w.dtype, w.data_ptr())
    timed_row(f"center_sq_dists N={n} K={k} D={d} f32 (route {route})",
              lambda: fr.center_sq_dists(w, conehot),
              lambda: ref.center_sq_dists(w, conehot),
              lambda: torch.cdist(w, centers),
              wb + 4 * (k * n + n * k), 2 * k * n * d + 3 * n * k * d,
              clean=True)
    timed_row(f"fused_coalition_stats N={n} K={k} D={d} f32 (route {route})",
              lambda: fr.fused_coalition_stats(w, m),
              lambda: ref.fused_coalition_stats(w, m), None,
              wb + 4 * (k * n + k * d + d + n * k),
              2 * k * n * d + k * d + d + 3 * n * k * d, clean=True)
    print_read_floor(w)
    torch.cuda.empty_cache()


def print_read_floor(w) -> None:
    """The read rate one PyTorch call reaches on W under the same timing:
    w.sum(), ATen's reduction, reads W once and writes one value."""
    nbytes = w.numel() * w.element_size()
    for clean in (False, True):
        ms = time_ms(lambda: w.sum(), clean=clean)
        print(f"time read floor w.sum() {tuple(w.shape)} {str(w.dtype)[6:]}, "
              f"{'clean L2' if clean else 'L2 flushed'}: {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s, "
              f"{100 * nbytes / PEAK_BYTES * 1e3 / ms:.1f}% of the byte "
              f"bound)")


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


def run_mesh_path(dense_server_s: list) -> None:
    """Phase j: ``train --mode fl --mesh data=1 --rounds 3`` at the
    defaults, counters reset just before: each fused kernel once a round
    and nothing else, ``backend_sharded`` cuda@data1, accuracy above
    chance; its server step beside the main path's.  Then the one-rank
    sharded round on seeded W (the main shape, f32 and bf16) equal to the
    dense cuda round bit for bit, and the sketch path on the mesh:
    ``segment_sum`` once a round on the tile (its sketch-space distances
    are plain torch, as the reference's)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import fused, sharded
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train

    label = f"train {' '.join(MESH_ARGS)}"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main(MESH_ARGS)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    report_rounds(out, label, wall, launches, ROUNDS)
    expect_launches(label, launches, {"center_sq_dists": ROUNDS,
                                      "fused_coalition_stats": ROUNDS})
    if out["backend_sharded"] != "cuda@data1" or out["mesh"] != "data=1":
        fail(f"{label}: mesh {out.get('mesh')!r}, backend "
             f"{out.get('backend_sharded')!r}")
    print(f"{label}: server step {out['server_s']} s against the main "
          f"path's {dense_server_s} s (collectives: {dist.get_backend()})")
    mesh = mesh_lib.parse_mesh("data=1")
    n, k, d = MAIN
    for dtype in (torch.float32, torch.bfloat16):
        w, _, _ = inputs(n, k, d, dtype, seed=5)
        ci = torch.tensor([0, 4, 7], device="cuda")
        dense = fused.fused_round(w, ci, backend="cuda")
        got = fused.fused_round(w, ci, backend=sharded.sharded_backend(
            "cuda", mesh))
        same = all(torch.equal(getattr(dense, f), getattr(got, f))
                   for f in dense._fields)
        print(f"phase j: the one-rank sharded round at ({n}, {d}) {dtype} "
              f"equal to the dense cuda round bit for bit: {same}")
        if not same:
            fail("phase j: the one-rank sharded round is not the dense one")
    label = f"train {' '.join(MESH_SKETCH_ARGS)}"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main(MESH_SKETCH_ARGS)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    report_rounds(out, label, wall, launches, 2)
    expect_launches(label, launches, {"segment_sum": 2})
    print(f"phase j (the sharded federation at world 1): done")


def shard_rank(rank: int, world: int, shapes) -> dict:
    """Phase k's rank body (a gloo rank sharing the card): the sharded cuda
    round on seeded W at each D, launches counted; then the times of its
    collectives, host clock around each, every call ending in a
    synchronise: the two (10, 3) all-reduces of a round and the θ
    all-gather, each the mean of 20."""
    import torch

    from repro_torch.core import fused, sharded
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.parse_mesh(f"data={world}")
    out = {}
    for n, k, d in shapes:
        w, _, _ = inputs(n, k, d, torch.float32, seed=7)
        ci = torch.tensor([0, 4, 7], device="cuda")
        ops.reset_launch_counts()
        r = fused.fused_round(w, ci, backend=sharded.sharded_backend(
            "cuda", mesh))
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        theta = sharded.gather_cols(r.theta, mesh, d)
        bary = sharded.gather_cols(r.barycenters, mesh, d)
        part = torch.zeros((n, k), device="cuda")
        times = {}
        for name, fn in (("all_reduce_ms", lambda: sharded.summed(part,
                                                                  mesh)),
                         ("gather_ms", lambda: sharded.gather_cols(
                             r.theta, mesh, d))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) / 20 * 1e3
        out[d] = {"launches": launches, "tile": tuple(r.theta.shape),
                  "assignment": r.assignment.cpu(),
                  "centers": r.new_center_idx.cpu(), "theta": theta.cpu(),
                  "barycenters": bary.cpu(), "med_d2": r.med_d2.cpu(),
                  **times}
    return out


def run_shard_path() -> dict:
    """Phase k: SHARD_RANKS gloo ranks sharing the card, spawned here, run
    the sharded cuda round on seeded W at (10, D) for D in SHARD_D: each
    rank's launches 1 + 1 on its odd-width contiguous tile; assignments and
    centers equal to the dense cuda round's, θ, barycenters and medoid
    distances within TOL of max.  Then, in this process, each rank's two
    kernels on its tile (CUDA events, L2 flushed) beside their bounds and
    the tile copy; the ranks' all-reduce and θ all-gather times.  Returns
    the kernels' rows at rank 1's tile of the CNN's D."""
    import torch

    from repro_torch.core import fused, sharded
    from repro_torch.kernels import fused_round as fr
    from repro_torch.kernels import ref
    from repro_torch.testing import run_ranks

    n, k, _ = MAIN
    shapes = [(n, k, d) for d in SHARD_D]
    t0 = time.perf_counter()
    got = run_ranks(shard_rank, SHARD_RANKS, shapes, device="cuda:0",
                    timeout=300)
    print(f"phase k: {SHARD_RANKS} gloo ranks sharing the card: "
          f"{time.perf_counter() - t0:.1f} s")
    rows = {}
    for _, _, d in shapes:
        w, conehot, m = inputs(n, k, d, torch.float32, seed=7)
        ci = torch.tensor([0, 4, 7], device="cuda")
        dense = fused.fused_round(w, ci, backend="cuda")
        for rank, res in enumerate(got):
            r = res[d]
            errs = {f: rel_err(r[f].cuda(), getattr(dense, f))[1]
                    for f in ("theta", "barycenters", "med_d2")}
            same = (torch.equal(r["assignment"], dense.assignment.cpu())
                    and torch.equal(r["centers"],
                                    dense.new_center_idx.cpu()))
            print(f"phase k rank {rank} D={d}: tile {r['tile']}, launches "
                  f"{r['launches']}, assignment and centers equal to the "
                  f"dense cuda round: {same}, / max errors "
                  f"{ {f: f'{e:.3e}' for f, e in errs.items()} }; "
                  f"(10, 3) all-reduce {r['all_reduce_ms']:.4f} ms, theta "
                  f"all-gather ({4 * d / 1e6:.1f} MB) {r['gather_ms']:.4f} "
                  f"ms (host clock, gloo)")
            expect_launches(f"phase k rank {rank} D={d}", r["launches"],
                            {"center_sq_dists": 1,
                             "fused_coalition_stats": 1})
            if not same or max(errs.values()) > TOL:
                fail(f"phase k: rank {rank}'s sharded round at D={d} is "
                     f"not the dense round")
        width = -(-d // SHARD_RANKS)
        for rank in range(SHARD_RANKS):
            copy_ms = time_ms(lambda: sharded.cut_tile(w, SHARD_RANKS, rank))
            tile = sharded.cut_tile(w, SHARD_RANKS, rank)
            route = fr.route(n, k, width, tile.dtype, tile.data_ptr())
            tb = n * width * 4
            print(f"time tile copy rank {rank} D={d}: {copy_ms:.4f} ms "
                  f"({2 * tb / 1e6:.1f} MB read and written, bound "
                  f"{bound(2 * tb, 0)[0]:.4f} ms), route {route}")
            pair = {
                "center_sq_dists": timed_row(
                    f"center_sq_dists N={n} K={k} D={width} f32, rank "
                    f"{rank}'s tile of D={d} (route {route})",
                    lambda: fr.center_sq_dists(tile, conehot),
                    lambda: ref.center_sq_dists(tile, conehot),
                    lambda: torch.cdist(tile, (conehot @ tile)),
                    tb + 4 * (k * n + n * k),
                    2 * k * n * width + 3 * n * k * width),
                "fused_coalition_stats": timed_row(
                    f"fused_coalition_stats N={n} K={k} D={width} f32, rank "
                    f"{rank}'s tile of D={d} (route {route})",
                    lambda: fr.fused_coalition_stats(tile, m),
                    lambda: ref.fused_coalition_stats(tile, m), None,
                    tb + 4 * (k * n + k * width + width + n * k),
                    2 * k * n * width + k * width + width
                    + 3 * n * k * width)}
            if d == SHARD_D[0] and rank == 1:
                for name, row in pair.items():
                    got_k = (fr.center_sq_dists(tile, conehot)
                             if name == "center_sq_dists"
                             else fr.fused_coalition_stats(tile, m))
                    want = (ref.center_sq_dists(tile, conehot)
                            if name == "center_sq_dists"
                            else ref.fused_coalition_stats(tile, m))
                    errs = [rel_err(g, r) for g, r in zip(
                        got_k if isinstance(got_k, tuple) else (got_k,),
                        want if isinstance(want, tuple) else (want,))]
                    row["err"] = max(e for e, _ in errs)
                    if max(r for _, r in errs) > TOL:
                        fail(f"phase k: {name} on rank 1's tile disagrees "
                             f"with its plain version")
                    row["kernel_route"] = route
                    row["launches"] = got[1][d]["launches"][name]
                    rows[name] = row
        del w
    return rows


def run_moe_ep_phase() -> None:
    """Phase l: one MoE layer of moonshot-v1-16b-a3b at full width (64
    experts, top 6, d 2048, ff 1408) in f32 on 4 x 32 tokens: moe_apply_ep
    on a one-rank (data=1, model=1) mesh against moe_apply, both drop counts
    printed at the config's capacity, the outputs compared at capacity 8.0
    (no drop on either) within MOE_TOL; its gradients finite."""
    import dataclasses

    import torch

    from repro_torch.configs import get
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe

    cfg = dataclasses.replace(get(MOE_ARCH), dtype="float32")
    params = moe.moe_init(torch.Generator(device="cuda").manual_seed(0), cfg,
                          device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((*MOE_TOKENS, cfg.d_model), generator=g, device="cuda")
    mesh = mesh_lib.parse_mesh("data=1,model=1")
    t = MOE_TOKENS[0] * MOE_TOKENS[1]
    for cf in (cfg.capacity_factor, 8.0):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        stats = {}
        with torch.no_grad():
            got, aux = moe.moe_apply_ep(params, c, x, mesh=mesh, stats=stats)
            want, want_aux = moe.moe_apply(params, c, x)
            keep = moe.dispatch(params, c, x.reshape(t, -1),
                                moe.capacity(c, t)).keep
        dense_drops = int((~keep).sum())
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"phase l {MOE_ARCH} f32 capacity {cf}: dropped pairs ep "
              f"{stats['dropped']} / dense {dense_drops} of {t * c.top_k}; "
              f"max abs err {err:.3e} (max |out| {scale:.3e}), aux "
              f"{float(aux):.6f} / {float(want_aux):.6f}")
        if cf == 8.0 and (stats["dropped"] or dense_drops
                          or err > MOE_TOL * max(1.0, scale)
                          or abs(float(aux) - float(want_aux)) > MOE_TOL):
            fail("phase l: moe_apply_ep disagrees with moe_apply")
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    xg = x.clone().requires_grad_()
    out, aux = moe.moe_apply_ep(p, cfg, xg, mesh=mesh)
    (out.square().mean() + aux).backward()
    finite = all(bool(torch.isfinite(v.grad).all()) for v in p.values()) \
        and bool(torch.isfinite(xg.grad).all())
    print(f"phase l: gradients finite: {finite}")
    if not finite:
        fail("phase l: moe_apply_ep's gradients are not finite")


def run_remat_phase() -> dict:
    """Phase m: hymba-1.5b in full, REMAT_STEPS Adam steps at lr 1e-3 with
    ``make_train_step(remat=True)`` and again with remat off, from the same
    init and batches, through the flash kernel: the first loss equal, the
    later ones within REMAT_RTOL relative; s/step, peak memory and flash
    launches a step for both."""
    import torch

    from repro_torch.configs import get
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf

    cfg = get("hymba-1.5b")
    toks = torch.from_numpy(synthetic.lm_tokens(
        10 * REMAT_STEPS, 129, cfg.vocab, seed=0)).cuda()
    layers.set_flash_kernel(True)
    runs = {}
    try:
        for remat in (True, False):
            model = tf.init(torch.Generator(device="cuda").manual_seed(0),
                            cfg, device="cuda")
            step, opt = steps.make_train_step(cfg, optimizer="adam",
                                              lr=float(PRETRAIN_LR),
                                              remat=remat)
            state = opt.init(dict(model.named_parameters()))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, secs, flash, retries = [], [], [], []
            for i in range(REMAT_STEPS):
                ops.reset_launch_counts()
                before = torch.cuda.memory_stats().get("num_alloc_retries", 0)
                t0 = time.perf_counter()
                losses.append(float(step(model, state, {
                    "tokens": toks[10 * i:10 * (i + 1)]})))
                secs.append(time.perf_counter() - t0)
                flash.append(ops.launch_counts()["flash_attention"])
                # the allocator's retries (cached blocks freed, the
                # allocation tried again) stall the host
                retries.append(torch.cuda.memory_stats().get(
                    "num_alloc_retries", 0) - before)
            runs[remat] = {"losses": losses, "step_s": secs,
                           "peak": torch.cuda.max_memory_allocated(),
                           "flash": flash, "alloc_retries": retries}
            del model, state, step, opt
            torch.cuda.empty_cache()
    finally:
        layers.set_flash_kernel(False)
    for remat, r in runs.items():
        print(f"phase m hymba-1.5b remat={remat}: losses {r['losses']}, "
              f"step seconds {[round(t, 4) for t in r['step_s']]}, peak "
              f"{r['peak'] / 2**30:.2f} GiB, flash launches a step "
              f"{r['flash']}, allocator retries a step {r['alloc_retries']}")
    on, off = runs[True]["losses"], runs[False]["losses"]
    if on[0] != off[0] or any(abs(a - b) > REMAT_RTOL * abs(b)
                              for a, b in zip(on[1:], off[1:])):
        fail(f"phase m: losses with remat {on} are not those without {off}")
    if any(f != 2 * cfg.n_layers for f in runs[True]["flash"]) or \
            any(f != cfg.n_layers for f in runs[False]["flash"]):
        fail("phase m: flash launches a step are not 2L with remat, L "
             "without")
    return runs


def start_dryrun_cli() -> list:
    """Phase n, first half: start the dry-run's CLI runs as subprocesses on
    the default device, all at once (they trace on the host, beside the
    world-1 steps); :func:`check_dryrun_cli` waits for them."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = []
    for args, want in DRYRUN_RUNS:
        # files, not pipes: a full pipe would stall the run until it is read
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        runs.append((args, want, time.perf_counter(), out, err,
                     subprocess.Popen(
                         [sys.executable, "-m", "repro_torch.launch.dryrun",
                          *args], stdout=out, stderr=err, env=env, cwd=ROOT)))
    return runs


def check_dryrun_cli(runs: list) -> None:
    """Each CLI run must exit 0 and print its line."""
    for args, want, t0, out_f, err_f, proc in runs:
        try:
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out_f.seek(0)
        err_f.seek(0)
        out, err = out_f.read(), err_f.read()
        print(f"phase n: dryrun {' '.join(args)}: exit {proc.returncode} "
              f"after {time.perf_counter() - t0:.1f} s")
        for line in out.splitlines():
            if line.startswith(("[", "  ", "dry-run")):
                print("  " + line)
        if proc.returncode != 0 or want not in out:
            print(err[-6000:], file=sys.stderr)
            fail(f"phase n: dryrun {' '.join(args)} did not print {want!r}")


def dryrun_hymba_step(mesh, fake: bool):
    """Phase n's LM step: hymba-1.5b in full, one Adam step at lr 1e-3 on
    a batch of DRYRUN_BATCH tokens, remat off, its parameters placed as
    DTensors on ``mesh``; stand-ins under the caller's FakeTensorMode, or
    real weights from seed 0 and real tokens."""
    import torch

    from repro_torch.configs import get
    from repro_torch.data import synthetic
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tf

    cfg = get("hymba-1.5b")
    if fake:
        gen = torch.Generator()
        toks = torch.empty(DRYRUN_BATCH, dtype=torch.int32, device="cuda")
    else:
        gen = torch.Generator(device="cuda").manual_seed(0)
        toks = torch.from_numpy(synthetic.lm_tokens(
            *DRYRUN_BATCH, cfg.vocab, seed=0)).cuda()
    model = tf.init(gen, cfg, device="cuda")
    step, args = dryrun.lm_step(cfg, "train", mesh, {"batch": {"tokens": toks}},
                                model=model, optimizer="adam", remat=False,
                                device="cuda")
    tokens = DRYRUN_BATCH[0] * DRYRUN_BATCH[1]
    return step, args, 6.0 * cfg.n_active_params() * tokens


def dryrun_fl_step(mesh, fake: bool):
    """Phase n's FL step: the paper CNN's coalition round at N =
    DRYRUN_FL_CLIENTS (5 local steps at batch 32, K = 8, the steady round)
    on ``stream``, every client on this rank; real arguments are seeded
    (one initial model in every client slot, uniform pixels, labels in
    0..9, centers 0, 32, ..., 224)."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.models import cnn

    n = DRYRUN_FL_CLIENTS
    step, args, d = dryrun.fl_round_step(mesh, n_clients=n, backend="stream",
                                         device="cuda")
    if not fake:
        stacked, batch, state = args
        gen = torch.Generator(device="cuda").manual_seed(0)
        one = cnn.init(torch.Generator().manual_seed(0), device="cuda")
        for k, v in stacked.items():
            v.copy_(one[k].expand_as(v))
        batch["x"].uniform_(generator=gen)
        batch["y"].random_(0, 10, generator=gen)
        k = state.center_idx.shape[0]
        state.center_idx.copy_(torch.arange(k, device="cuda") * (n // k))
    return step, args, 6.0 * d * n * 32 * 5


#: phase n's world-1 steps: (label, builder)
DRYRUN_STEPS = (("hymba-1.5b Adam step", "dryrun_hymba_step"),
                (f"FL round N={DRYRUN_FL_CLIENTS} stream", "dryrun_fl_step"))


def dryrun_trace(out_path: str) -> None:
    """Phase n's traces (``chip_smoke.py DRYRUN_TRACE OUT``, a process of
    its own, beside the real runs): each world-1 step on fake CUDA tensors
    under the counting mode, its counts written to OUT as JSON."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import analysis, dryrun

    mesh = dryrun.fake_mesh({"data": 1, "model": 1}, "cuda")
    out = {}
    try:
        for label, builder in DRYRUN_STEPS:
            t0 = time.perf_counter()
            with FakeTensorMode():
                step, args, model_flops = globals()[builder](mesh, True)
                c = analysis.Counter()
                c.hold(args)
                with dryrun.counted_step(c) as reshard:
                    step(*args)
            out[label] = {
                "flops": c.flops, "bytes": c.bytes, "peak": c.peak_bytes,
                "held": c.held_bytes, "resharded": dict(reshard.counts),
                "trace_s": time.perf_counter() - t0,
                "roofline": analysis.roofline(
                    c, chips=1, model_flops_global=model_flops)}
            del step, args
        # the counter's own check on this torch: on a (4, 4) fake mesh a
        # rank counts 1/16 of an evenly split toy's FLOPs
        from repro_torch.testing import sharded_toy_flops

        out["toy"] = {str(h): sharded_toy_flops(h, "cuda")
                      for h in DRYRUN_TOY_HIDDEN}
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def dryrun_real(label: str, build, mesh) -> dict:
    """Phase n at world 1: ``build(mesh, False)``'s step run for real, under
    the counting mode from a reset peak (cuBLAS and cuDNN are warm from the
    earlier phases), then timed without it."""
    import torch

    from repro_torch.launch import analysis, dryrun

    step, args, _ = build(mesh, False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    real = analysis.Counter()
    real.hold(args)
    with dryrun.counted_step(real):
        step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - start
    t0 = time.perf_counter()
    with dryrun.counted_step(None):
        step(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    del step, args
    torch.cuda.empty_cache()
    return {"flops": real.flops, "bytes": real.bytes, "peak": peak,
            "held": start, "counted_peak": real.peak_bytes, "step_s": step_s}


def check_dryrun_steps(traced: dict, real: dict) -> None:
    """Each world-1 step's traced FLOPs and bytes within 1% of the real
    run's, its traced peak within 10% of ``max_memory_allocated`` over the
    bytes held at the start; prints the roofline beside the step time.
    The toy on a (4, 4) fake mesh: a rank's FLOPs x 16 equal to the
    unsharded count where every dim divides, above it where one does not."""
    even, odd = (traced["toy"][str(h)] for h in DRYRUN_TOY_HIDDEN)
    print(f"phase n toy on a (4, 4) fake mesh: hidden {even['hidden']} rank "
          f"{even['rank_flops']} x 16 against {even['global_flops']}; hidden "
          f"{odd['hidden']} rank {odd['rank_flops']} x 16 against "
          f"{odd['global_flops']} (useful {odd['useful_ratio']:.3f})")
    if even["rank_flops"] * 16 != even["global_flops"] or \
            odd["rank_flops"] * 16 <= odd["global_flops"] or \
            not 0 < odd["useful_ratio"] <= 1:
        fail("phase n: the counter does not count a rank's share of the toy")
    for label, _ in DRYRUN_STEPS:
        t, r = traced[label], real[label]
        roof = t["roofline"]
        print(f"phase n {label}: flops traced {t['flops']:.6e} real "
              f"{r['flops']:.6e}; bytes traced {t['bytes']:.6e} real "
              f"{r['bytes']:.6e}; peak traced {t['peak'] / 2**30:.4f} GiB "
              f"over {t['held'] / 2**30:.4f} GiB held, max_memory_allocated "
              f"{r['peak'] / 2**30:.4f} GiB over {r['held'] / 2**30:.4f} "
              f"GiB allocated at the start (the real run's own count "
              f"{r['counted_peak'] / 2**30:.4f} GiB); roofline compute "
              f"{roof['compute_s']:.4e} s, memory {roof['memory_s']:.4e} s, "
              f"collective {roof['collective_s']:.4e} s "
              f"({roof['bottleneck']}) beside a measured step of "
              f"{r['step_s']:.4f} s (traced in {t['trace_s']:.1f} s, "
              f"fallbacks {t['resharded']}) on {card_line()}")
        for key, tol in DRYRUN_RTOL.items():
            if abs(t[key] - r[key]) > tol * abs(r[key]):
                fail(f"phase n {label}: traced {key} {t[key]} is not within "
                     f"{tol:.0%} of the real run's {r[key]}")
    hymba = traced[DRYRUN_STEPS[0][0]]["flops"]
    if f"{hymba:.6e}" != DRYRUN_HYMBA_FLOPS:
        fail(f"phase n: the hymba step counts {hymba:.6e} FLOPs, not "
             f"{DRYRUN_HYMBA_FLOPS}")


def run_dryrun_phase() -> dict:
    """Phase n: the dry-run's CLI and the world-1 traces in processes of
    their own, beside the world-1 steps' real runs here; then the checks."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    cli = start_dryrun_cli()
    fd, trace_path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    tracer = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               DRYRUN_TRACE, trace_path])
    try:
        mesh = dryrun.fake_mesh({"data": 1, "model": 1}, "cuda")
        try:
            real = {label: dryrun_real(label, globals()[builder], mesh)
                    for label, builder in DRYRUN_STEPS}
        finally:
            dist.destroy_process_group()
        if tracer.wait(timeout=900) != 0:
            fail(f"phase n: the world-1 traces exited {tracer.returncode}")
        with open(trace_path) as f:
            traced = json.load(f)
    finally:
        if tracer.poll() is None:
            tracer.kill()
            tracer.wait()
        os.unlink(trace_path)
        check_dryrun_cli(cli)
    check_dryrun_steps(traced, real)
    print(f"phase n (the dry-run on the card): {time.perf_counter() - t0:.1f} s")
    return {"traced": traced, "real": real}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == [RESUME_CHECK]:
        resume_check(sys.argv[2])
        return 0
    if sys.argv[1:2] == [DRYRUN_TRACE]:
        dryrun_trace(sys.argv[2])
        return 0
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
    print_flash_attributes()
    check_sweep_attributes()

    errs = check_kernels()
    dist_errs = check_dist_kernels()
    flash_errs = check_flash()
    composed_routes = check_rounds()
    times = time_kernels()
    conv_rows = time_conv_pool()
    flash_rows = time_flash()
    times["flash_attention"] = flash_rows[FLASH_PATH]
    launches, main_server_s = run_main_path()
    run_mesh_path(main_server_s)
    run_fedavg_path()
    run_straggler_path()
    run_event_path()
    run_coupled_path()
    run_cohort_path()
    run_attack_path()
    tmp = tempfile.mkdtemp(prefix=".smoke-host-", dir=ROOT)
    try:
        host = run_host_path(tmp)
        serve_fl = run_serve_fl_path(host["store"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tiny = run_tiny_path()
    shard = run_shard_path()
    print(f"host summary: snapshot write {max(host['publish_s']):.4f} s "
          f"max, checkpoint write {max(host['save_s']):.4f} s max, resume "
          f"{host['resume_s']:.2f} s (restore {host['restore_s']:.4f} s, "
          f"bit for bit, deterministic algorithms); serve "
          f"--mode fl {serve_fl['qps']} queries/s at the defaults, "
          f"{serve_fl['steady_qps']} steady, swap_ms_mean "
          f"{serve_fl['swap_ms']}")
    sketch_routes, w = run_sketch_path()
    pair_routes, pair_err = run_pairwise(w)
    del w
    big = framework_scale()
    profile_round()
    pretrain_launches = run_pretrain_path()
    model, batch = full_model()
    check_forward(model, batch)
    profile_pretrain_step(model, batch)
    del model, batch
    torch.cuda.empty_cache()
    run_remat_phase()
    run_moe_ep_phase()
    serves = {arch: run_serve_phase(arch, extra)
              for arch, extra in SERVE_PHASES}
    run_dryrun_phase()
    for arch, r in serves.items():
        print(f"serve summary {arch}: prefill_s {r['prefill_s']!r}, "
              f"decode_s_per_tok {r['decode_s_per_tok']!r}, peak "
              f"{r['peak'] / 2**30:.2f} GiB, decode bound {r['bound_ms']:.4f} "
              f"ms, decode/forward {r['decode_ratio']:.3e} (bf16), "
              f"{r['decode_ratio_f32']:.3e} (f32), traced decode busy "
              f"{100 * r['busy']:.1f}% with {r['kernels']:.0f} kernels a "
              f"token, launches "
              f"{r['launches']}")

    n, k, d = MAIN
    errs["flash_attention"] = flash_errs[FLASH_PATH]
    errs.update({
        "sq_dists_to_points": dist_errs[("sq_dists_to_points", n, k,
                                         SKETCH_DIM)],
        "segment_sum": dist_errs[("segment_sum", n, k, d)],
        "pairwise_sq_dists": pair_err})
    main_shape = f"N={n} K={k} D={d} f32"
    shapes = {name: main_shape for name in REPLACES}
    shapes["pairwise_sq_dists"] = f"N={n} D={d} f32"
    shapes["sq_dists_to_points"] = f"N={n} K={k} D=S={SKETCH_DIM} f32"
    shapes["flash_attention"] = f"{FLASH_PATH[:6]} bf16"
    # each line's launches: the path that gives the kernel that shape, run
    # with the counters at 0 just before, and of the distance and
    # segment-sum kernels only the launches at the row's route and D
    paths = {"center_sq_dists": ("main path", launches),
             "fused_coalition_stats": ("main path", launches),
             "flash_attention": ("pretrain path", pretrain_launches)}
    widths = {"sq_dists_to_points": SKETCH_DIM, "segment_sum": d}
    sketch_label = f"sketch path ({' '.join(SKETCH_ARGS)})"

    def on_path(name, row, width, label, routes):
        return label, routes[(name, row["kernel_route"], width)]

    paths["pairwise_sq_dists"] = on_path(
        "pairwise_sq_dists", times["pairwise_sq_dists"], d,
        "pairwise on the sketch run's W", pair_routes)

    # (name, shape, timed row, max abs error, (path, launches)) of each
    # line; the distance and segment-sum kernels also at full width and at
    # D = 8M
    lines = []
    for name in REPLACES:
        row = times[name]
        path = paths.get(name) or on_path(name, row, widths[name],
                                          sketch_label, sketch_routes)
        lines.append((name, shapes[name], row, errs[name], path))
    full = times["sq_dists_to_points full"]
    lines.insert(4, ("sq_dists_to_points", f"{main_shape} (full W)", full,
                     dist_errs[("sq_dists_to_points", n, k, d)],
                     on_path("sq_dists_to_points", full, d,
                             f"composed round N={n} K={k} D={d}",
                             composed_routes)))
    lines += [(name, f"N={n} K={k} D={BIG_D} f32", big[name],
               big[name]["err"],
               on_path(name, big[name], BIG_D,
                       f"composed round N={n} K={k} D={BIG_D}",
                       big["routes"]))
              for name in ("sq_dists_to_points", "segment_sum")]
    lines.append(("pairwise_sq_dists", f"N={n} D={BIG_D} f32",
                  big["pairwise_sq_dists"], big["pairwise_sq_dists"]["err"],
                  on_path("pairwise_sq_dists", big["pairwise_sq_dists"],
                          BIG_D, f"pairwise N={n} D={BIG_D}",
                          big["pairwise routes"])))
    encoder_arch = next(a for a, extra in SERVE_PHASES if "--flash" in extra)
    n_t, k_t, d_t = TINY
    lines += [(name, f"N={n_t} K={k_t} D={d_t} bf16", tiny[name],
               tiny[name]["err"],
               (f"transformer_tiny path ({' '.join(TINY_ARGS)})",
                tiny["launches"]))
              for name in ("center_sq_dists", "fused_coalition_stats")]
    width = -(-d // SHARD_RANKS)
    lines += [(name, f"N={n} K={k} D={width} f32 (rank 1's tile of D={d})",
               shard[name], shard[name]["err"],
               (f"sharded round, {SHARD_RANKS} gloo ranks, rank 1",
                shard[name]["launches"]))
              for name in ("center_sq_dists", "fused_coalition_stats")]
    lines.append(("flash_attention", f"{FLASH_ENCODER[:6]} bf16 non-causal",
                  flash_rows[FLASH_ENCODER], flash_errs[FLASH_ENCODER],
                  (f"serve path ({encoder_arch} --flash)",
                   serves[encoder_arch]["launches"])))
    lines += [(name, f"C={c} B={b} f32", row, row["err"],
               ("main path", launches))
              for (name, c, b), row in conv_rows.items()]
    kernels = []
    for name, shape, row, err, (path, count) in lines:
        if isinstance(count, dict):
            count = count[name]
        if count < 1:
            fail(f"{name} at {shape} launched no time on the {path}")
        kernels.append({
            "name": name, "shape": shape, "route": "cuda",
            "kernel_route": row.get("kernel_route"),
            "source": SOURCES[name],
            "replaces": REPLACES.get(name, "none (ATen's depthwise conv1)"),
            "launches": count, "launches_on": path, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
