"""Serving entry point of the PyTorch port: ``--mode lm``, LM generation,
and ``--mode fl``, coalition-routed federation serving.

``--mode lm`` (the default) prefills a batch of prompts through a reduced
or full assigned architecture (``--arch``, default falcon-mamba-7b), then
decodes ``--gen`` tokens with the KV-cache / SSM-state serving path of
:mod:`repro_torch.models.transformer`.  The weights are a random init from
``--seed``, the prompts ``synthetic.lm_tokens``, and a VLM's or the
encoder-decoder's modal input a seeded stub of frame or patch embeddings.
``--flash`` routes the cache-free attention (the encoder-decoder's encoder,
non-causal) through the hand-written flash kernel.  It prints the
reference's JSON keys (``arch``, ``generated_shape``, ``first_seq``,
``prefill_s``, ``decode_s_per_tok``) plus ``device``; the times end in a
device synchronise.

``--mode fl`` is the consumer half of the train/serve pair: it attaches to
a :class:`repro_torch.serve.ModelStore` that a federation run publishes
into (``train.py --snapshot-dir``; the reference's snapshots serve too),
builds the coalition routing table from the latest snapshot and answers
``--repeat`` batches of ``--batch`` queries, each through its client's
coalition barycenter (unknown clients get θ), polling the store between
batches and hot-swapping newer rounds in place.  ``--model cnn`` serves
(B, 28, 28, 1) images, ``--model transformer`` (B, 16) token batches
through ``--arch`` (token-only archs).  It prints the reference's JSON keys
plus ``device``; ``--metrics-out`` streams one ``serve_batch`` ledger
record a batch.

The run is on a CUDA card unless the caller passes ``--device cpu``;
without a card and without ``--device cpu`` it exits non-zero.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --full
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-large-v2 --full --flash
  PYTHONPATH=src python -m repro_torch.launch.serve --mode fl \
      --store-dir /tmp/fl-store --batch 32 --repeat 8
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.launch.train import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, batch: dict, *, max_new: int, cache_len: int,
             greedy: bool = True, generator: torch.Generator | None = None,
             gumbel: torch.Tensor | None = None):
    """Prefill, then ``max_new`` decode steps.  Returns (tokens (B,
    max_new), stats): the first token is the prefill's argmax, each later
    one the argmax of a decode step's logits, or with ``greedy=False`` a
    sample, argmax(logits + Gumbel noise) as ``jax.random.categorical``
    draws it: the noise ``gumbel[i]`` (max_new, B, vocab) where given,
    else drawn from ``generator``.  ``stats``: ``prefill_s``,
    ``decode_s_per_tok`` (host seconds, each ended by a device
    synchronise) and ``logits_finite``."""
    from repro_torch.models import transformer as tf

    tokens = batch["tokens"]
    device = tokens.device
    b = tokens.shape[0]
    with torch.no_grad():
        cache = tf.init_cache(model.cfg, b, cache_len, device=device)
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = tf.prefill(model, batch, cache)
        _sync(device)
        prefill_s = time.perf_counter() - t0

        finite = torch.isfinite(logits).all()
        toks = []
        tok = torch.argmax(logits, dim=-1)
        t0 = time.perf_counter()
        for i in range(max_new):
            toks.append(tok)
            logits, cache = tf.decode_step(model, tok, cache)
            finite &= torch.isfinite(logits).all()
            if greedy:
                tok = torch.argmax(logits, dim=-1)
            else:
                noise = gumbel[i] if gumbel is not None else -torch.log(
                    torch.empty_like(logits).exponential_(
                        generator=generator))
                tok = torch.argmax(logits + noise.to(logits), dim=-1)
        _sync(device)
        decode_s = time.perf_counter() - t0
    return torch.stack(toks, dim=1), {
        "prefill_s": prefill_s, "decode_s_per_tok": decode_s / max_new,
        "logits_finite": bool(finite)}


def run_lm(args, *, model=None, modal: torch.Tensor | None = None) -> dict:
    """Serve one batch: init, prefill and decode; print the reference's
    keys plus ``device``.  The random draws may be given instead: ``model``
    (its parameters; e.g. the reference's, by ``carry``) and ``modal``, the
    stub's (B, P, d_modal) input.  Returns the printed keys and, beside
    them, the generated ``tokens``, the ``model``, its ``batch`` and
    ``logits_finite``."""
    from repro_torch.configs import get, reduced
    from repro_torch.data import synthetic
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf

    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    layers.set_flash_kernel(args.flash)
    cfg = get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    gen = torch.Generator(device=device)
    if model is None:
        model = tf.init(gen.manual_seed(args.seed), cfg, device=device)
    toks = synthetic.lm_tokens(args.batch, args.prompt_len, cfg.vocab,
                               seed=args.seed)
    batch = {"tokens": torch.from_numpy(toks).to(device)}
    if cfg.modality:
        batch["modal"] = (modal.to(device) if modal is not None else
                          torch.randn((args.batch, cfg.n_modal_tokens,
                                       cfg.d_modal),
                                      generator=gen.manual_seed(1),
                                      device=device))
    prefix = cfg.n_modal_tokens if (cfg.modality and not cfg.enc_dec) else 0
    out, stats = generate(model, batch, max_new=args.gen,
                          cache_len=prefix + args.prompt_len + args.gen,
                          generator=gen.manual_seed(args.seed + 2))
    layers.set_flash_kernel(False)
    result = {"arch": cfg.name, "generated_shape": list(out.shape),
              "first_seq": [int(t) for t in out[0][:8]],
              "prefill_s": stats["prefill_s"],
              "decode_s_per_tok": stats["decode_s_per_tok"],
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")}
    print(json.dumps(result))
    if not stats["logits_finite"]:
        raise RuntimeError(f"{cfg.name}: non-finite logits while serving")
    return {**result, "tokens": out, "model": model, "batch": batch,
            "logits_finite": stats["logits_finite"]}


def make_apply_fn(model: str, arch: str, use_reduced: bool,
                  device: torch.device):
    """``(apply_fn, make_queries, layout)`` of a served model family.

    ``cnn`` serves (B, 28, 28, 1) images -> (B, 10) logits (the paper's
    federated model); ``transformer`` serves (B, T) token batches ->
    (B, T, vocab) logits through the assigned architecture, its parameters
    passed in through ``functional_call``.  ``make_queries(b, seed)``
    gives a seeded batch on ``device``.
    """
    if model == "cnn":
        from repro_torch.models import cnn

        def make_queries(b, seed):
            return torch.randn(
                (b, 28, 28, 1),
                generator=torch.Generator(device=device).manual_seed(seed),
                device=device)

        return cnn.apply, make_queries, cnn.REF_LAYOUT
    from torch.func import functional_call

    from repro_torch import carry
    from repro_torch.configs import get, reduced
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as tf

    cfg = get(arch)
    if use_reduced:
        cfg = reduced(cfg)
    if cfg.modality or cfg.enc_dec:
        raise SystemExit(
            f"--mode fl serves token-only architectures; {cfg.name} needs "
            "modal inputs (use --mode lm for its generate path)")
    # a parameter-free module: the served parameters come in every call
    net = tf.init(torch.Generator(), cfg, device="meta")

    def apply_fn(params, toks):
        return functional_call(net, params, ({"tokens": toks},))[0]

    def make_queries(b, seed):
        return torch.from_numpy(synthetic.lm_tokens(
            b, 16, cfg.vocab, seed=seed)).to(device)

    return apply_fn, make_queries, carry.transformer_layout(net)


def run_fl_serve(args) -> dict:
    """Attach to a ModelStore and serve routed batches from its latest
    round; print and return the reference's keys plus ``device``."""
    from repro_torch import obs
    from repro_torch.serve import GLOBAL, BatchServer, ModelStore

    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    store = ModelStore(args.store_dir)
    deadline = time.time() + args.wait
    while store.latest_round() is None:
        if time.time() >= deadline:
            raise SystemExit(
                f"no snapshots under {args.store_dir} after {args.wait}s — "
                "is a train.py --snapshot-dir run publishing there?")
        time.sleep(0.2)
    snap = store.load(device=device)
    apply_fn, make_queries, layout = make_apply_fn(
        args.model, args.arch, args.reduced, device)
    server = BatchServer(apply_fn, layout, snap, device=device)

    n_known = snap.assignment.size
    # query ids sweep the known population plus one stranger per batch, so
    # every batch exercises both coalition routing and the global fallback
    ids = np.arange(args.batch) % (n_known + 1)
    ids = np.where(ids == n_known, -1, ids)
    # the serve-side run ledger: one serve_batch record per answered batch
    sink = (obs.make_sink("jsonl", path=args.metrics_out)
            if args.metrics_out else None)
    swaps = served = 0
    checksum = torch.zeros((), dtype=torch.float64, device=device)
    t0 = time.time()
    for i in range(args.repeat):
        swaps += int(server.poll(store))      # hot-swap newer rounds
        tb = time.perf_counter()
        out = server.serve(ids, make_queries(args.batch, args.seed + i))
        served += int(out.shape[0])
        checksum += torch.sum(out.double())
        if sink is not None:
            if device.type == "cuda":     # the batch's time on the card
                torch.cuda.synchronize(device)
            c = server.stats
            sink.emit({
                "schema": obs.OBS_SCHEMA, "kind": obs.SERVE_BATCH,
                "batch": i, "round": server.round,
                "batch_ms": round((time.perf_counter() - tb) * 1e3, 3),
                **c,
                "poll_hit_rate": round(c["poll_hits"] / max(c["polls"], 1),
                                       4),
                "fallback_rate": round(
                    c["fallback_queries"] / max(c["queries"], 1), 4)})
    checksum = float(checksum)                # synchronises
    wall = time.time() - t0
    if sink is not None:
        sink.close()
    if not np.isfinite(checksum):
        raise RuntimeError("served logits contain NaN/Inf")
    routes = server.routing.route(ids)
    c = server.stats
    stats = {
        "mode": "fl", "model": args.model, "store": args.store_dir,
        "round": server.round, "published_rounds": store.rounds(),
        "n_coalitions": int(snap.barycenters.shape[0]),
        "batch": args.batch, "repeat": args.repeat,
        "queries_per_s": round(served / wall, 1),
        "global_fallback_queries": int(np.sum(routes == GLOBAL)),
        "hot_swaps": swaps,
        "compile_count": server.compile_count,
        "swap_ms_mean": round(c["swap_ms_total"] / max(c["swaps"], 1), 3),
        "poll_hit_rate": round(c["poll_hits"] / max(c["polls"], 1), 4),
        "fallback_rate": round(c["fallback_queries"] / max(c["queries"], 1),
                               4),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    if args.metrics_out:
        stats["metrics_out"] = args.metrics_out
    print(json.dumps(stats, indent=1))
    return stats


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", default="lm", choices=["lm", "fl"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; exits "
                         "non-zero without a card unless this is cpu)")
    ap.add_argument("--arch", default="falcon-mamba-7b")
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--reduced", dest="reduced", action="store_true",
                      help="serve the reduced (CPU-smoke) config [default]")
    size.add_argument("--full", dest="reduced", action="store_false",
                      help="serve the full-size config")
    ap.set_defaults(reduced=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flash", action="store_true",
                    help="route the cache-free attention through the "
                         "hand-written flash kernel")
    # fl (ModelStore consumer)
    ap.add_argument("--store-dir", default=None,
                    help="ModelStore directory a federation run publishes "
                         "into (required for --mode fl)")
    ap.add_argument("--model", default="cnn", choices=["cnn", "transformer"],
                    help="served model family; must match what the "
                         "publishing run trained")
    ap.add_argument("--repeat", type=int, default=4,
                    help="number of batches to serve (polling the store "
                         "for newer rounds between batches)")
    ap.add_argument("--wait", type=float, default=0.0,
                    help="seconds to wait for the first published snapshot")
    ap.add_argument("--metrics-out", default=None,
                    help="stream per-batch serve counters (queries/s, swap "
                         "latency, poll hit/miss, routing fallback rate) to "
                         "this JSONL file via the repro_torch.obs ledger")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.mode == "fl":
        if args.store_dir is None:
            raise SystemExit("--mode fl requires --store-dir")
        return run_fl_serve(args)
    return run_lm(args)


if __name__ == "__main__":
    main()
